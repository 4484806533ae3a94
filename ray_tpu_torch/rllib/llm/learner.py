"""GRPO-style LLM learner over the train/ SPMD machinery: the port of
``ray_tpu/rllib/llm/learner.py``.

The update is one step built by `train.spmd.make_train_step`, the same
TrainState/partition-rules/batch-sharding path the supervised trainer
uses (on a mesh: batch sharded over (data, fsdp), params laid out by
the model's rules, DTensor inserting the gradient collectives), with a
GRPO policy-gradient loss instead of next-token cross entropy:

    ratio  = exp(logp_new - logp_old)          per generated token
    adv    = (r - mean_group) / (std_group+ε)  per sequence (GRPO)
    loss   = -mean over generated tokens of
             min(ratio * adv, clip(ratio, 1±ε_clip) * adv)

On the card the forward runs flash attention's kernel K1 (and again in
the full-remat replay) and the backward K2 and K3. `logp_old` comes
from the serving engine's rollout stream (the behaviour policy at the
tagged weight version), so the clipped importance ratio absorbs exactly
one flywheel lap of staleness; the **staleness guard** drops
trajectories that are older than `max_staleness` versions or tagged
stale (mixed weight versions): their logprobs are not reproducible at
any single version, and feeding them in corrupts the ratios silently.

The learner runs on the card unless the caller passes ``device="cpu"``
(or a mesh, whose device it takes). An update is an
``rl.learner_update`` span.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch import interop
from ray_tpu_torch.parallel.mesh import BATCH_AXES, mesh_shape
from ray_tpu_torch.parallel.sharding import replicate_like, shard_pytree
from ray_tpu_torch.rllib.llm.trajectory import (
    Trajectory,
    group_relative_advantages,
    to_train_batch,
)
from ray_tpu_torch.serve.llm.engine import resolve_device
from ray_tpu_torch.serve.llm.runner import logprob_at
from ray_tpu_torch.train.optim import adam, chain, clip_by_global_norm
from ray_tpu_torch.train.spmd import TrainState, make_train_step
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.metrics import Counter, Histogram


@dataclasses.dataclass
class LLMLearnerConfig:
    lr: float = 1e-3
    clip_eps: float = 0.2  # PPO-style ratio clip
    grad_clip: float = 1.0
    group_eps: float = 1e-6  # GRPO advantage denominator
    # trajectories sampled more than this many weight versions before
    # the CURRENT learner version are dropped (0 = on-policy only; the
    # synchronous flywheel produces staleness 0, pipelined rollouts 1)
    max_staleness: int = 1
    # sampling temperature the rollouts ran at; logp_new is scaled the
    # same way so ratio == 1 at zero divergence
    temperature: float = 1.0


def _families() -> dict:
    from ray_tpu_torch.models import gpt2, llama

    return {
        "gpt2": (gpt2.gpt2_forward, gpt2.init_gpt2,
                 gpt2.gpt2_partition_rules, gpt2.GPT2Config.tiny),
        "llama": (llama.llama_forward, llama.init_llama,
                  llama.llama_partition_rules, llama.LlamaConfig.tiny),
    }


def _f32_on(device: torch.device, params: Any) -> Any:
    """A float32 copy of a tree of tensors or host arrays on `device`."""
    def one(t):
        if isinstance(t, torch.Tensor):
            return t.detach().to(device, torch.float32, copy=True)
        return torch.from_numpy(np.array(t, np.float32)).to(device)
    return tree.tree_map(one, params)


class LLMLearner:
    """Owns params + optimizer for one model family ("gpt2"/"llama");
    `update(trajectories)` runs one GRPO step and bumps the weight
    version; `publish_weights()` hands the new version to the serving
    side (through the object store when a runtime is up)."""

    def __init__(self, model: str = "gpt2", model_config: Any = None,
                 *, params: Any = None, mesh=None,
                 config: LLMLearnerConfig | None = None, seed: int = 0,
                 device=None):
        families = _families()
        if model not in families:
            raise ValueError(
                f"unknown model {model!r}; have {sorted(families)}")
        forward, init_fn, rules_fn, default_cfg = families[model]
        self.model = model
        self.cfg = model_config if model_config is not None \
            else default_cfg()
        self.config = config or LLMLearnerConfig()
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device_type if mesh is not None else device)
        self._forward = forward
        self._rules = rules_fn()
        self.version = 0  # last PUBLISHED weight version
        self.tx = chain(clip_by_global_norm(self.config.grad_clip),
                        adam(self.config.lr))
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_fn(gen, self.cfg, device=self.device)
        else:
            # the learner's own f32 copy: its update writes the tensors
            # in place, which must not reach the caller's (an engine's)
            params = _f32_on(self.device, params)
        if mesh is not None:
            params = shard_pytree(params, self._rules, mesh)
        # optimizer moments are zeros_like(params): they inherit the
        # param layouts, the layout stage 0 of the ZeRO ladder keeps
        self.state = TrainState.create(params, self.tx)

        cfg = self.config
        vocab = self.cfg.vocab_size
        temp = max(cfg.temperature, 1e-6)

        def loss_fn(params, batch):
            logits = forward(params, batch["inputs"], self.cfg)
            # log-softmax over the real vocab: the padding's -1e9 adds
            # exp(-1e9 - max) == 0 to the sum, as JAX's slice leaves it
            # out, and keeps a vocab-sharded DTensor's layout
            real = replicate_like(
                torch.arange(logits.shape[-1], device=logits.device),
                logits) < vocab
            logp_all = torch.log_softmax(
                torch.where(real, logits / temp, -1e9), dim=-1)
            lp = logp_all.gather(
                -1, batch["targets"].long()[..., None])[..., 0]
            mask = batch["mask"]
            ratio = torch.exp(lp - batch["old_logprobs"]) * mask
            adv = batch["advantages"][:, None]
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
                * adv)
            denom = torch.clamp(mask.sum(), min=1.0)
            return -(surr * mask).sum() / denom

        self._train_step = make_train_step(
            loss_fn, self.tx, mesh=mesh,
            rules=self._rules if mesh is not None else None)
        self._build_metrics()

    # ----------------------------------------------------------- metrics

    def _build_metrics(self):
        tags = {"model": self.model}
        self._m_tags = tags
        self._m_staleness = Histogram(
            "rl_traj_staleness",
            "Weight-version lag (learner version - trajectory version) "
            "of trajectories offered to the learner",
            boundaries=(0, 1, 2, 3, 5, 8), tag_keys=("model",))
        self._m_dropped = Counter(
            "rl_traj_dropped_total",
            "Trajectories dropped by the staleness guard",
            tag_keys=("model", "reason"))

    # ------------------------------------------------------------ update

    def filter_stale(self, trajs: list[Trajectory]
                     ) -> tuple[list[Trajectory], dict]:
        """The staleness guard. Observes rl_traj_staleness for every
        offered trajectory, drops `stale` (mixed-version) ones and ones
        more than `max_staleness` versions behind the current learner
        version; returns (kept, drop-count dict)."""
        kept: list[Trajectory] = []
        dropped = {"stale": 0, "too_old": 0}
        for t in trajs:
            lag = self.version - t.weight_version
            self._m_staleness.observe(max(0, lag), tags=self._m_tags)
            if t.stale:
                dropped["stale"] += 1
            elif lag > self.config.max_staleness:
                dropped["too_old"] += 1
            else:
                kept.append(t)
        for reason, n in dropped.items():
            if n:
                self._m_dropped.inc(
                    n, tags={"model": self.model, "reason": reason})
        return kept, dropped

    def _check_temperature(self, trajs: list[Trajectory]) -> None:
        """The loss scales logp_new by config.temperature; rollout
        logprobs were recorded at each trajectory's own τ (greedy
        records the unscaled policy log-prob, i.e. effective τ=1). A
        mismatch silently biases every importance ratio, so fail loud
        instead of training on corrupted ratios."""
        want = max(self.config.temperature, 1e-6)
        for t in trajs:
            eff = t.temperature if t.temperature > 0 else 1.0
            if abs(eff - want) > 1e-6:
                raise ValueError(
                    f"trajectory sampled at temperature {eff} but the "
                    f"learner is configured for {want}: importance "
                    f"ratios would be systematically biased — set "
                    f"RolloutConfig.temperature == "
                    f"LLMLearnerConfig.temperature")

    def update(self, trajs: list[Trajectory]) -> dict:
        """One GRPO step over a trajectory batch: staleness guard →
        group-relative advantages → clipped policy-gradient update.
        Bumps the published weight version."""
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        with tracing.span("rl.learner_update"):
            kept, dropped = self.filter_stale(trajs)
            self._check_temperature(kept)
            if not kept:
                return {"skipped": True, "kept": 0,
                        "dropped_stale": dropped["stale"],
                        "dropped_too_old": dropped["too_old"]}
            adv = group_relative_advantages(kept, self.config.group_eps)
            batch = to_train_batch(kept, adv, max_len=self.cfg.block_size)
            self.state, metrics = self._train_step(self.state, batch)
            self.version += 1
        rewards = np.asarray([t.reward for t in kept], np.float32)
        return {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "version": self.version,
            "kept": len(kept),
            "dropped_stale": dropped["stale"],
            "dropped_too_old": dropped["too_old"],
            "reward_mean": float(rewards.mean()),
            "reward_std": float(rewards.std()),
            "update_seconds": time.perf_counter() - t0,
        }

    # ----------------------------------------------------------- weights

    def get_weights(self) -> Any:
        """Host-side float32 copy of the params tree (numpy arrays; on a
        mesh the whole tensors, gathered on every rank)."""
        return interop.params_to_numpy(self.state.params)

    def publish_weights(self) -> tuple[int, Any]:
        """(version, weights-or-ref) for the serving side. With a
        runtime initialized the host tree goes through the object store
        — ONE put, every replica pulls the same ref via
        `DeploymentHandle.update_weights(version, ref)`; in-process
        callers get the tree directly, for
        ``LLMEngine.update_weights(version, weights)``."""
        import ray_tpu_torch as ray

        w = self.get_weights()
        if ray.is_initialized():
            return self.version, ray.put(w)
        return self.version, w

    @torch.no_grad()
    def teacher_forced_logprobs(self, traj: Trajectory,
                                params: Any = None) -> np.ndarray:
        """Per-generated-token log-probs of `traj` under a teacher-
        forced forward at `params` (default: current learner params; a
        tree of tensors or host arrays, such as `get_weights()`), scaled
        by the TRAJECTORY's own sampling temperature (greedy recorded
        the unscaled policy log-prob, so τ=0 maps to 1) — exactly how
        the engine recorded them. For a non-stale trajectory whose
        weight_version matches the params, these reproduce
        `traj.logprobs`: the determinism contract RL.md documents and
        the tests gate."""
        if params is None:
            p = self.state.params
        else:
            p = _f32_on(self.device, params)
        # on a mesh the forward shards the batch over (data, fsdp): one
        # copy of the sequence a rank of those axes
        rows = 1 if self.mesh is None else math.prod(
            mesh_shape(self.mesh).get(a, 1) for a in BATCH_AXES)
        seq = torch.tensor([traj.prompt + traj.tokens] * rows,
                           device=self.device)
        logits = self._forward(p, replicate_like(seq, tree.leaves(p)[0]),
                               self.cfg)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        logits = logits[0].double().cpu().numpy()
        g0 = len(traj.prompt) - 1
        # the engine records logprobs with the same shared logprob_at,
        # so the contract holds by construction
        out = [logprob_at(logits[g0 + i], tok, traj.temperature,
                          self.cfg.vocab_size)
               for i, tok in enumerate(traj.tokens)]
        return np.asarray(out, np.float64)
