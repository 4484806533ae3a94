"""DQN — the off-policy, replay-buffer based family: the port of
``ray_tpu/rllib/dqn.py``.

Reference parity: rllib/algorithms/dqn (new API stack): EnvRunners
collect transitions with epsilon-greedy exploration into a replay buffer
(utils/replay_buffers/), the learner samples minibatches and applies the
(double-)DQN TD target with a periodically synced target network
(torch variant: dqn_torch_learner.py). The update runs on the
algorithm's device; the target network is a copied tree, refreshed
every `target_update_freq` updates. The TD errors come to the host once
an update, for the priorities.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.util import tree


class ReplayBuffer:
    """Uniform FIFO replay (reference: EpisodeReplayBuffer simplified to
    transition granularity)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int64)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.bool_)
        self.size = 0
        self.pos = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        n = len(actions)
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.next_obs[idx] = next_obs
        self.dones[idx] = dones
        self.pos = int((self.pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def __len__(self):
        return self.size

    def sample(self, batch_size: int, rng: np.random.RandomState) -> dict:
        idx = rng.randint(0, self.size, batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx].astype(np.float32),
        }


@dataclasses.dataclass
class DQNConfig(AlgorithmConfig):
    rollout_fragment_length: int = 16
    lr: float = 5e-4
    buffer_capacity: int = 50_000
    train_batch_size: int = 64
    num_steps_sampled_before_learning: int = 1000
    target_update_freq: int = 500  # learner updates between target syncs
    updates_per_iteration: int = 32
    double_q: bool = True
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 10_000
    # proportional prioritized replay (reference: PER via segment trees,
    # rllib/execution/segment_tree.py + prioritized_episode_buffer)
    prioritized_replay: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4

    def build(self) -> "DQN":
        return DQN(self)


def td_loss(params, target_params, batch: dict, gamma: float,
            double_q: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The PER-weighted Huber TD loss and the TD errors of a batch of
    device tensors; the Q values are the policy head's logits."""
    q = models.forward(params, batch["obs"])[0]
    q_taken = q.gather(1, batch["actions"][:, None])[:, 0]
    with torch.no_grad():
        q_next_target = models.forward(target_params, batch["next_obs"])[0]
        if double_q:
            best = torch.argmax(
                models.forward(params, batch["next_obs"])[0], dim=1)
            q_next = q_next_target.gather(1, best[:, None])[:, 0]
        else:
            q_next = q_next_target.max(dim=1).values
        target = batch["rewards"] + gamma * (1 - batch["dones"]) * q_next
    td = q_taken - target
    huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
    # importance weights correct the PER sampling bias (uniform replay
    # passes ones)
    return (batch["weights"] * huber).mean(), td


class DQN(Algorithm):
    """Epsilon-greedy sampling rides the PPO env-runner machinery: the
    runner samples from its categorical head over Q-logits sharpened by
    1/epsilon on the learner-side weight sync, so sampling tends to
    greedy as epsilon decays."""

    config_class = DQNConfig
    STATE_COMPONENTS = ("params", "target_params", "opt_state",
                        "_env_steps", "_updates", "_iteration",
                        "_timesteps_total")

    def setup(self, config: DQNConfig):
        probe = _envs.make(config.env)
        self.obs_dim = int(np.prod(probe.observation_space.shape))
        self.n_actions = int(probe.action_space.n)
        probe.close()

        gen = torch.Generator(device=self.device)
        gen.manual_seed(config.seed)
        self.params = models.init_mlp_policy(
            gen, self.obs_dim, self.n_actions, config.hidden,
            device=self.device)
        self.target_params = tree.tree_map(torch.clone, self.params)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(self.params)
        if config.prioritized_replay:
            from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer

            self.buffer = PrioritizedReplayBuffer(
                config.buffer_capacity, alpha=config.per_alpha,
                beta=config.per_beta, seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity, self.obs_dim)
        self._rng = np.random.RandomState(config.seed)
        self._env_steps = 0
        self._updates = 0

        self.env_runner_group = EnvRunnerGroup(
            num_env_runners=config.num_env_runners,
            remote=config.num_env_runners > 0,
            env=config.env,
            num_envs=config.num_envs_per_env_runner,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed,
            hidden=config.hidden,
            device=self.device,
        )
        self._sync_runner_weights()

    def _update(self, batch: dict[str, np.ndarray]
                ) -> tuple[float, np.ndarray]:
        """One Adam step on a host batch (with its PER ``weights``):
        the loss and the TD errors, read to the host in one copy."""
        cfg = self.config
        dev = {k: torch.from_numpy(np.asarray(v)).to(self.device)
               for k, v in batch.items()}
        leaves = tree.leaves(self.params)
        for p in leaves:
            p.requires_grad_(True)
        loss, td = td_loss(self.params, self.target_params, dev,
                           cfg.gamma, cfg.double_q)
        # the value tower is not in the loss: its grads are zeros, as
        # jax.grad gives them
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        self.params, self.opt_state = self.tx.update(
            tree.unflatten(self.params, grads), self.opt_state, self.params)
        host = torch.cat([loss.detach()[None], td.detach()]).cpu().numpy()
        return float(host[0]), host[1:]

    # -- exploration -----------------------------------------------------

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final -
                                             cfg.epsilon_initial)

    def _sync_runner_weights(self):
        """Scale Q-logits so the runner's categorical sampling acts
        epsilon-greedy-ish: low epsilon -> sharp (greedy) distribution."""
        eps = max(self._epsilon(), 1e-3)
        sharpness = 1.0 / eps
        w = self.get_weights()
        last = w["pi"][-1]
        w["pi"][-1] = {"w": last["w"] * sharpness, "b": last["b"] * sharpness}
        self.env_runner_group.sync_weights(w)

    # -- training --------------------------------------------------------

    def training_step(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        samples = self.env_runner_group.sample()
        ep_returns, env_steps = [], 0
        for s in samples:
            # transitions (o_t, a_t, r_t, o_{t+1}): the final step of a
            # fragment has no in-fragment successor — drop it (1/T of
            # data) rather than fabricate one; drop autoreset steps too:
            # their action was ignored by the env and their successor
            # belongs to the next episode (done-step pairs stay — done=1
            # already masks their bootstrap)
            rm = s["reset_mask"]
            valid = (~rm[:-1]).reshape(-1)
            obs = s["obs"][:-1].reshape(-1, s["obs"].shape[-1])[valid]
            nxt = s["obs"][1:].reshape(-1, s["obs"].shape[-1])[valid]
            acts = s["actions"][:-1].reshape(-1)[valid]
            rews = s["rewards"][:-1].reshape(-1)[valid]
            dns = s["dones"][:-1].reshape(-1)[valid]
            if cfg.prioritized_replay:
                self.buffer.add_batch({
                    "obs": obs, "actions": acts, "rewards": rews,
                    "next_obs": nxt, "dones": dns.astype(np.float32),
                })
            else:
                self.buffer.add_batch(obs, acts, rews, nxt, dns)
            env_steps += s["env_steps"]
            if s["num_episodes"]:
                ep_returns.append(s["episode_return_mean"])
        self._env_steps += env_steps

        losses = []
        if len(self.buffer) >= cfg.num_steps_sampled_before_learning:
            for _ in range(cfg.updates_per_iteration):
                if cfg.prioritized_replay:
                    batch = self.buffer.sample(cfg.train_batch_size)
                    idxs = batch.pop("idxs")
                else:
                    batch = self.buffer.sample(cfg.train_batch_size,
                                               self._rng)
                    batch["weights"] = np.ones(
                        len(batch["actions"]), np.float32)
                    idxs = None
                loss, td = self._update(batch)
                if idxs is not None:
                    self.buffer.update_priorities(idxs, td)
                losses.append(loss)
                self._updates += 1
                if self._updates % cfg.target_update_freq == 0:
                    self.target_params = tree.tree_map(
                        lambda t: t.detach().clone(), self.params)
        self._sync_runner_weights()
        dt = time.perf_counter() - t0
        return {
            "episode_return_mean": float(np.mean(ep_returns))
            if ep_returns else float("nan"),
            "num_env_steps_sampled_lifetime": self._env_steps,
            "env_steps_per_sec": env_steps / dt,
            "epsilon": self._epsilon(),
            "learner/td_loss": float(np.mean(losses)) if losses
            else float("nan"),
            "buffer_size": len(self.buffer),
        }

    def get_weights(self):
        return tree.tree_map(
            lambda t: t.detach().to("cpu", copy=True).numpy(), self.params)

    def cleanup(self):
        self.env_runner_group.shutdown()
