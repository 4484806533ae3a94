"""Multi-agent RL — MultiRLModule + multi-agent PPO: the port of
``ray_tpu/rllib/multi_agent.py``.

Reference parity: rllib/core/rl_module/multi_rl_module.py:49 (a dict of
RLModules keyed by module id), the MultiAgentEnv API
(rllib/env/multi_agent_env.py — dict obs/rewards/dones with "__all__"),
and policy mapping (config.multi_agent(policy_mapping_fn=...)). The
learner side reuses the port's single-agent PPO learner per module:
each module's batch is assembled from the agents mapped to it and
updated on the config's device (the card unless it says
``device="cpu"``). Actions are drawn with `models.sample_actions` from a
seeded `torch.Generator`, where JAX splits a key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.learner import (
    PPOLearner,
    PPOLearnerConfig,
    compute_gae,
)
from ray_tpu_torch.util.device import resolve_device


class MultiAgentEnv:
    """Dict-keyed env protocol (reference: rllib/env/multi_agent_env.py).
    step() returns (obs, rewards, terminateds, truncateds, infos) dicts;
    terminateds["__all__"] ends the episode."""

    agents: list[str] = []

    def reset(self, *, seed=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError


class CoordinationGame(MultiAgentEnv):
    """Two agents are rewarded for choosing the SAME action; obs is the
    one-hot of the previous joint action. A minimal learnable testbed
    (the repeated-matrix-game pattern of rllib/examples/multi_agent); a
    copy of the JAX package's."""

    agents = ["a0", "a1"]
    obs_dim = 4
    n_actions = 2

    def __init__(self, episode_len: int = 25):
        self.episode_len = episode_len
        self._rng = np.random.default_rng(0)

    def _obs(self):
        o = np.zeros(4, np.float32)
        o[self._prev] = 1.0
        return {a: o.copy() for a in self.agents}

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._prev = int(self._rng.integers(0, 4))
        return self._obs(), {}

    def step(self, action_dict: dict):
        a0, a1 = int(action_dict["a0"]), int(action_dict["a1"])
        r = 1.0 if a0 == a1 else 0.0
        self._prev = a0 * 2 + a1
        self._t += 1
        done = self._t >= self.episode_len
        rewards = {a: r for a in self.agents}
        term = {a: done for a in self.agents}
        term["__all__"] = done
        trunc = {a: False for a in self.agents}
        trunc["__all__"] = False
        return self._obs(), rewards, term, trunc, {}


class MultiRLModule:
    """Dict of per-module policy learners (reference:
    multi_rl_module.py:49). Modules are the unit of optimization;
    agents map onto modules via policy_mapping_fn (parameter sharing =
    many agents -> one module)."""

    def __init__(self, learners: dict[str, PPOLearner],
                 policy_mapping_fn: Callable[[str], str]):
        self.learners = learners
        self.policy_mapping_fn = policy_mapping_fn

    def __getitem__(self, module_id: str) -> PPOLearner:
        return self.learners[module_id]

    def module_for(self, agent_id: str) -> str:
        return self.policy_mapping_fn(agent_id)

    def get_weights(self) -> dict:
        return {m: l.get_weights() for m, l in self.learners.items()}


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env_maker: Callable[[], MultiAgentEnv] = CoordinationGame
    policies: tuple = ("shared",)  # module ids
    policy_mapping_fn: Callable[[str], str] = lambda aid: "shared"
    rollout_episodes: int = 16
    gamma: float = 0.99
    lambda_: float = 0.95
    lr: float = 5e-3
    num_sgd_iter: int = 4
    minibatch_size: int = 256
    entropy_coeff: float = 0.01
    hidden: tuple = (32, 32)
    seed: int = 0
    device: str = "cuda"  # where the learners and the sampling run

    def multi_agent(self, policies=None, policy_mapping_fn=None
                    ) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = tuple(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """training_step: sample episodes from the multi-agent env, split
    experience per MODULE, per-module GAE + PPO update (reference:
    multi-agent training_step assembling MultiAgentBatch per module)."""

    def __init__(self, config: MultiAgentPPOConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.env = config.env_maker()
        probe_obs, _ = self.env.reset(seed=config.seed)
        obs_dim = len(next(iter(probe_obs.values())))
        n_actions = getattr(self.env, "n_actions", 2)
        lcfg = PPOLearnerConfig(
            lr=config.lr, entropy_coeff=config.entropy_coeff,
            num_sgd_iter=config.num_sgd_iter,
            minibatch_size=config.minibatch_size, hidden=config.hidden)
        self.module = MultiRLModule(
            {m: PPOLearner(obs_dim, n_actions, lcfg,
                           seed=config.seed + i, device=self.device)
             for i, m in enumerate(config.policies)},
            config.policy_mapping_fn)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed + 99)
        self._iteration = 0

    @torch.no_grad()
    def _act(self, module_id: str, obs) -> tuple[int, float, float]:
        """(action, logp, value) of one agent's observation, in one
        copy back to the host."""
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(
            self.device)
        a, logp, val = models.sample_actions(self.module[module_id].params,
                                             x, self._gen)
        a, logp, val = torch.stack(
            [a.to(logp.dtype), logp, val])[:, 0].cpu().tolist()
        return int(a), logp, val

    def _rollout(self):
        """Sample episodes; returns per-agent trajectories."""
        cfg = self.config
        trajs = {a: {"obs": [], "actions": [], "logp": [], "values": [],
                     "rewards": [], "dones": []}
                 for a in self.env.agents}
        ep_returns = []
        for ep in range(cfg.rollout_episodes):
            obs, _ = self.env.reset(seed=cfg.seed * 1000 + self._iteration
                                    * 100 + ep)
            done, total = False, 0.0
            while not done:
                actions = {}
                for a, o in obs.items():
                    act, logp, val = self._act(self.module.module_for(a), o)
                    actions[a] = act
                    t = trajs[a]
                    t["obs"].append(np.asarray(o, np.float32))
                    t["actions"].append(act)
                    t["logp"].append(logp)
                    t["values"].append(val)
                obs, rewards, term, trunc, _ = self.env.step(actions)
                done = term.get("__all__") or trunc.get("__all__")
                for a, r in rewards.items():
                    trajs[a]["rewards"].append(float(r))
                    trajs[a]["dones"].append(bool(done))
                total += sum(rewards.values()) / len(rewards)
            ep_returns.append(total)
        return trajs, ep_returns

    def module_batches(self, trajs) -> dict[str, dict]:
        """Per-agent trajectories -> one flat batch per MODULE, GAE per
        agent (reference: MultiAgentBatch assembly)."""
        cfg = self.config
        per_module: dict[str, dict] = {}
        for agent, t in trajs.items():
            m = self.module.module_for(agent)
            T = len(t["rewards"])
            if T == 0:
                continue
            adv, targets = compute_gae(
                np.asarray(t["rewards"], np.float32).reshape(T, 1),
                np.asarray(t["values"], np.float32).reshape(T, 1),
                np.asarray(t["dones"]).reshape(T, 1),
                np.zeros(1, np.float32), cfg.gamma, cfg.lambda_)
            dst = per_module.setdefault(
                m, {"obs": [], "actions": [], "logp_old": [],
                    "advantages": [], "value_targets": []})
            dst["obs"].append(np.stack(t["obs"]))
            dst["actions"].append(np.asarray(t["actions"], np.int64))
            dst["logp_old"].append(np.asarray(t["logp"], np.float32))
            dst["advantages"].append(adv.reshape(-1))
            dst["value_targets"].append(targets.reshape(-1))
        return {m: {k: np.concatenate(v) for k, v in batch.items()}
                for m, batch in per_module.items()}

    def train(self) -> dict:
        t0 = time.perf_counter()
        trajs, ep_returns = self._rollout()
        metrics = {m: self.module[m].update(flat)
                   for m, flat in self.module_batches(trajs).items()}
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": float(np.mean(ep_returns)),
            "env_steps_per_sec": (sum(len(t["rewards"])
                                      for t in trajs.values())
                                  / (time.perf_counter() - t0)),
            **{f"learner/{m}/{k}": v for m, mm in metrics.items()
               for k, v in mm.items()},
        }
