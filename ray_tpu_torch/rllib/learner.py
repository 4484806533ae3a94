"""PPO Learner: the port of ``ray_tpu/rllib/learner.py``.

Reference parity: Learner (rllib/core/learner/learner.py:109 —
compute_losses/compute_gradients/apply_gradients/update_from_batch).
The update runs on the learner's device (the card unless the caller
passes another) with the JAX learner's optimizer,
``chain(clip_by_global_norm(grad_clip), adam(lr))`` from
``train/optim.py``. Each `update` puts the train batch on the device
once, indexes its minibatches there in the JAX learner's order
(``np.random.RandomState(0)`` per update), and reads the metrics to the
host once, after the last minibatch. The minibatch loop runs under
``catalog.deterministic_convs``, so a conv learner's seeded updates
repeat on the card.

On a mesh (a DeviceMesh with a ``data`` axis) the params are replicated
DTensors and each minibatch is a DTensor sharded on its rows over every
mesh dim, so DTensor inserts the gradient all-reduce that GSPMD inserts
in the JAX learner. Every rank holds the whole train batch (the
algorithm runs on every rank from the same seed) and keeps its own
rows. GAE is computed host-side before the update (the reference puts
it in the learner connector).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.rllib import catalog
from ray_tpu_torch.rllib.env_runner import copy_weights_
from ray_tpu_torch.rllib.rl_module import DefaultActorCriticModule
from ray_tpu_torch.train.optim import adam, chain, clip_by_global_norm
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.device import resolve_device


@dataclasses.dataclass
class PPOLearnerConfig:
    lr: float = 3e-4
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.0
    vf_clip_param: float = 10.0
    grad_clip: float = 0.5
    num_sgd_iter: int = 6
    minibatch_size: int = 128
    hidden: tuple = (64, 64)


def compute_gae(rewards, values, dones, last_values, gamma: float,
                lam: float):
    """(T, N) arrays -> (advantages, value_targets), host-side numpy
    (reference: GAE in the learner connector,
    rllib/connectors/learner/general_advantage_estimation.py)."""
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_value = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    targets = adv + values
    return adv, targets


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) with the population std (numpy's
    ``adv.std()``, as the JAX learner takes it; ``Tensor.std`` would
    apply Bessel's correction)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


class PPOLearner:
    """Owns params + optimizer; `update` runs epochs of minibatch SGD.
    Pass a DeviceMesh to shard each minibatch over its dims (the params
    replicated); without one it runs on `device`."""

    def __init__(self, obs_dim, n_actions: int,
                 config: PPOLearnerConfig | None = None, mesh=None,
                 seed: int = 0, model_config: dict | None = None,
                 module=None, device=None):
        self.config = config or PPOLearnerConfig()
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device_type if mesh is not None else device)
        self.tx = chain(clip_by_global_norm(self.config.grad_clip),
                        adam(self.config.lr))
        # obs_dim: int (vector, legacy towers) or a 3-tuple image shape
        # (catalog conv actor-critic — core/models/catalog.py:33); the
        # RLModule owns the net, and runner and learner construct
        # identical modules so weight sync is a tree copy
        mc = dict(model_config or {})
        mc.setdefault("hidden", self.config.hidden)
        if module is None:
            module = DefaultActorCriticModule(obs_dim, n_actions, mc,
                                              device=self.device)
        self.module = module
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.module.init(gen)
        if mesh is not None:
            params = tree.tree_map(
                lambda t: distribute_tensor(
                    t, mesh, [Replicate()] * mesh.ndim), params)
        self.params = tree.tree_map(lambda t: t.requires_grad_(True),
                                    params)
        self.opt_state = self.tx.init(self.params)

    def _loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        cfg = self.config
        out = self.module.forward_train(self.params, batch)
        logits, value = out["action_dist_inputs"], out["vf_preds"]
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        policy_loss = -surr.mean()
        vf_err = torch.clamp((value - batch["value_targets"]) ** 2,
                             0.0, cfg.vf_clip_param)
        vf_loss = vf_err.mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = policy_loss + cfg.vf_loss_coeff * vf_loss \
            - cfg.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_kl": (batch["logp_old"] - logp).mean()}

    def _minibatch(self, batch: dict, idx: torch.Tensor) -> dict:
        mb = {k: v[idx] for k, v in batch.items()}
        if self.mesh is None:
            return mb
        # every rank holds the whole minibatch and keeps its own rows
        rows = [Shard(0)] * self.mesh.ndim
        return {k: distribute_tensor(v, self.mesh, rows, src_data_rank=None)
                for k, v in mb.items()}

    def sgd_step(self, batch: dict) -> dict:
        """One optimizer step on a minibatch of device tensors; the
        metrics stay on the device."""
        leaves = tree.leaves(self.params)
        total, aux = self._loss(batch)
        grads = torch.autograd.grad(total, leaves)
        self.params, self.opt_state = self.tx.update(
            tree.unflatten(self.params, grads), self.opt_state, self.params)
        aux["total_loss"] = total
        return {k: v.detach() for k, v in aux.items()}

    # -- public ----------------------------------------------------------

    def update(self, train_batch: dict[str, np.ndarray]) -> dict:
        """Epochs of shuffled minibatch SGD (reference:
        Learner.update_from_batch minibatch loop, learner.py:967)."""
        cfg = self.config
        n = train_batch["obs"].shape[0]
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                 for k, v in train_batch.items()}
        batch["advantages"] = normalize_advantages(batch["advantages"])
        mb = min(cfg.minibatch_size, n)
        n_mb = max(1, n // mb)
        rng = np.random.RandomState(0)
        metrics: dict = {}
        with catalog.deterministic_convs():
            for _ in range(cfg.num_sgd_iter):
                perm = torch.from_numpy(rng.permutation(n)).to(self.device)
                for i in range(n_mb):
                    metrics = self.sgd_step(
                        self._minibatch(batch, perm[i * mb:(i + 1) * mb]))
        names = sorted(metrics)
        vals = torch.stack([
            v.full_tensor() if isinstance(v, DTensor) else v
            for v in (metrics[k] for k in names)]).cpu().tolist()
        return dict(zip(names, vals))

    def get_weights(self):
        """Host numpy copies of the params (on a mesh the whole tensors,
        gathered on every rank)."""
        return params_to_numpy(self.params)

    def set_weights(self, weights):
        """Copy a tree of host arrays into the params in place."""
        copy_weights_(self.params, weights)
