"""Offline RL — experience recording, offline datasets, BC and MARWIL:
the port of ``ray_tpu/rllib/offline.py``.

Reference parity: rllib/offline/offline_data.py:22 (OfflineData wraps a
ray.data dataset of experiences feeding learners),
rllib/algorithms/bc (behavior cloning from logged episodes) and
rllib/algorithms/marwil (advantage-weighted BC). Experiences are
recorded by an env runner into jsonl/parquet through
``ray_tpu_torch.data``, which runs on the port's local runtime (call
``ray_tpu_torch.init(local_mode=True)`` first); the offline learner is
one autograd update per minibatch on the algorithm's device (the card
unless the config says ``device="cpu"``), fed from the dataset's rows
held there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.util import tree


def record_experiences(env: str, num_episodes: int, out_dir: str,
                       seed: int = 0, hidden=(64, 64), params=None,
                       fmt: str = "jsonl", device=None):
    """Roll out a (random or given) policy and persist experiences as a
    ray_tpu_torch.data-readable dataset (reference: offline recording
    via EnvRunner output_config -> ray.data write). The runner's policy
    runs on `device` (the card unless the caller names another)."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner

    runner = SingleAgentEnvRunner(env=env, num_envs=4,
                                  rollout_fragment_length=128, seed=seed,
                                  hidden=hidden, device=device)
    if params is not None:
        runner.set_weights(params)
    rows = []
    episodes_done = 0
    while episodes_done < num_episodes:
        s = runner.sample()
        T, N = s["rewards"].shape
        # ENV-MAJOR row order: each env's steps are contiguous and
        # time-ordered so downstream return scans chain within one
        # trajectory only. The last row of each env's fragment segment
        # carries an explicit TRUNCATED flag (distinct from `done`, like
        # gymnasium's terminated/truncated split) so return scans stop at
        # the boundary without mistaking it for a real terminal.
        for n in range(N):
            seg_rows = []
            for t in range(T):
                if s["reset_mask"][t, n]:
                    continue
                seg_rows.append({
                    "obs": [float(x) for x in s["obs"][t, n].reshape(-1)],
                    "action": int(s["actions"][t, n]),
                    "reward": float(s["rewards"][t, n]),
                    "done": bool(s["dones"][t, n]),
                    "truncated": False,
                    "logp": float(s["logp"][t, n]),
                })
            if seg_rows and not seg_rows[-1]["done"]:
                seg_rows[-1]["truncated"] = True
            rows.extend(seg_rows)
        episodes_done += s["num_episodes"]
    ds = rd.from_items(rows, parallelism=8)
    if fmt == "parquet":
        return ds.write_parquet(out_dir)
    return ds.write_jsonl(out_dir)


def load_offline_dataset(path: str):
    """OfflineData role (offline_data.py:22): a Dataset of experience
    rows for offline training. Format is sniffed from the files on disk
    (reads are LAZY, so a wrong-format guess would only explode later
    inside a map task)."""
    import glob as _glob
    import os as _os

    from ray_tpu_torch import data as rd

    names = (_glob.glob(_os.path.join(path, "*"))
             if _os.path.isdir(path) else [path])
    if any(n.endswith((".parquet", ".pq")) for n in names):
        return rd.read_parquet(path)
    return rd.read_json(path)


@dataclasses.dataclass
class BCConfig(AlgorithmConfig):
    """Reference: rllib/algorithms/bc/bc.py — supervised action
    cloning on logged states; rides the shared AlgorithmConfig so BC
    runs as a Tune trial like the online families."""

    input_path: str = ""
    lr: float = 1e-3
    train_batch_size: int = 256
    # MARWIL generalization (marwil.py): beta > 0 weights the cloning
    # loss by exp(beta * advantage) where advantage is the discounted
    # return minus a learned value baseline; beta = 0 is plain BC.
    beta: float = 0.0
    vf_coeff: float = 1.0

    def offline_data(self, input_path: str) -> "BCConfig":
        self.input_path = input_path
        return self

    def build(self) -> "BC":
        return BC(self)


@dataclasses.dataclass
class MARWILConfig(BCConfig):
    beta: float = 1.0

    def build(self) -> "BC":
        return BC(self)


def bc_loss(params, batch: dict, beta: float, vf_coeff: float):
    """(total, (bc, vf)): the cloning loss, advantage-weighted by
    exp(beta * normalized advantage) when beta > 0 (MARWIL), plus
    vf_coeff times the value baseline's squared error."""
    logits, value = models.forward(params, batch["obs"])
    logp = torch.log_softmax(logits, dim=-1).gather(
        1, batch["actions"][:, None])[:, 0]
    if beta > 0.0:
        adv = batch["returns"] - value
        w = torch.exp(beta * (adv / (adv.abs().mean() + 1e-8)).detach())
        bc = -torch.mean(w * logp)
        vf = torch.mean(adv ** 2)
        return bc + vf_coeff * vf, (bc, vf)
    return -torch.mean(logp), (-torch.mean(logp), 0.0)


class BC(Algorithm):
    """Behavior cloning / MARWIL driver on the shared Algorithm base:
    one supervised update per minibatch over the offline dataset.
    `evaluate(env, ...)` takes the env EXPLICITLY (offline algos carry
    no sampling env in the config)."""

    config_class = BCConfig
    STATE_COMPONENTS = ("params", "opt_state", "_iteration",
                        "_timesteps_total")

    def setup(self, config: BCConfig):
        rows = load_offline_dataset(config.input_path).take_all()
        if not rows:
            raise ValueError(f"no offline rows at {config.input_path!r}")
        obs = np.asarray([r["obs"] for r in rows], np.float32)
        acts = np.asarray([r["action"] for r in rows], np.int64)
        rews = np.asarray([r["reward"] for r in rows], np.float32)
        # return chains break at real terminals AND at recording
        # truncations (fragment boundaries) — a truncated chain's return
        # is a known underestimate, never a cross-trajectory mix
        dones = np.asarray([r["done"] or r.get("truncated", False)
                            for r in rows], np.bool_)
        # Monte-Carlo returns per (recorded) trajectory for MARWIL's
        # advantage weighting
        returns = np.zeros(len(rows), np.float32)
        g = 0.0
        for i in range(len(rows) - 1, -1, -1):
            g = 0.0 if dones[i] else g
            g = rews[i] + config.gamma * g
            returns[i] = g
        self._data = {k: torch.from_numpy(v).to(self.device)
                      for k, v in (("obs", obs), ("actions", acts),
                                   ("returns", returns))}
        self.obs_dim = obs.shape[1]
        self.n_actions = int(acts.max()) + 1

        gen = torch.Generator(device=self.device)
        gen.manual_seed(config.seed)
        self.params = models.init_mlp_policy(
            gen, self.obs_dim, self.n_actions, config.hidden,
            device=self.device)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(self.params)
        self._rng = np.random.RandomState(config.seed)

    def _update(self, batch: dict) -> torch.Tensor:
        """One update of the params on a batch of device tensors;
        returns the total loss as a 0-d device tensor."""
        cfg = self.config
        leaves = tree.leaves(self.params)
        for p in leaves:
            p.requires_grad_(True)
        total, _ = bc_loss(self.params, batch, cfg.beta, cfg.vf_coeff)
        # plain BC leaves the value tower out of the loss: its grads are
        # zeros, as JAX's
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        self.params, self.opt_state = self.tx.update(
            tree.unflatten(self.params, grads), self.opt_state,
            self.params)
        return total.detach()

    def training_step(self) -> dict:
        cfg = self.config
        n = len(self._data["actions"])
        t0 = time.perf_counter()
        losses = []
        perm = torch.from_numpy(self._rng.permutation(n)).to(self.device)
        mb = min(cfg.train_batch_size, n)
        for i in range(max(1, n // mb)):
            idx = perm[i * mb:(i + 1) * mb]
            losses.append(self._update(
                {k: v[idx] for k, v in self._data.items()}))
        # one host copy of the iteration's losses
        loss = float(torch.stack(losses).mean())
        return {
            "learner/loss": loss,
            "num_samples": n,
            "time_s": time.perf_counter() - t0,
        }

    @torch.no_grad()
    def evaluate(self, env: str | None = None,
                 num_episodes: int = 20) -> dict:
        """Greedy rollout of the cloned policy on the port's env
        (reference: BC eval via evaluation env runners). `env` defaults
        to config.env so the base Algorithm.step() evaluation hook works
        too."""
        from ray_tpu_torch.rllib import envs as _envs

        e = _envs.make(env or self.config.env)
        returns = []
        for ep in range(num_episodes):
            obs, _ = e.reset(seed=1000 + ep)
            total, done = 0.0, False
            while not done:
                x = torch.from_numpy(
                    np.asarray(obs, np.float32).reshape(1, -1))
                logits, _ = models.forward(self.params, x.to(self.device))
                action = int(torch.argmax(logits[0]))
                obs, r, term, trunc, _ = e.step(action)
                total += float(r)
                done = term or trunc
            returns.append(total)
        e.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": num_episodes}

    def get_weights(self):
        return params_to_numpy(self.params)
