"""SAC — off-policy continuous control (squashed-Gaussian actor, twin Q):
the port of ``ray_tpu/rllib/sac.py``.

Reference parity: rllib/algorithms/sac (sac.py SACConfig, the torch
learner's twin-Q + tanh-Gaussian policy + auto-tuned entropy
temperature, default_sac_rl_module). One update performs the critic,
actor and temperature steps on the algorithm's device; target critics
track by Polyak averaging. Continuous action spaces (`Box`, the port's
Pendulum-v1); replay is the prioritized buffer with ``alpha=0``.

The Gaussian noise comes from the algorithm's `torch.Generator` on its
device, where JAX splits a key; every stochastic function also takes the
noise as a tensor (`eps`), so a test can pass the draws of JAX's keys.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.util import tree

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _mlp_init(gen, sizes, out_scale=1.0, device=None):
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = np.sqrt(2.0 / a) if i < len(sizes) - 2 else out_scale
        layers.append({
            "w": torch.randn((a, b), generator=gen, device=device) * scale,
            "b": torch.zeros(b, device=device)})
    return layers


def _mlp(layers, x):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def init_sac_params(gen, obs_dim: int, act_dim: int, hidden=(256, 256),
                    device=None) -> dict:
    return {
        "pi": _mlp_init(gen, (obs_dim, *hidden, 2 * act_dim), 0.01, device),
        "q1": _mlp_init(gen, (obs_dim + act_dim, *hidden, 1), 1.0, device),
        "q2": _mlp_init(gen, (obs_dim + act_dim, *hidden, 1), 1.0, device),
    }


def sample_action(params, obs, gen=None, eps=None):
    """Squashed Gaussian: a = tanh(mu + std*eps); returns (a, logp).
    `eps` is standard normal noise of the action's shape, drawn from
    `gen` when not given."""
    out = _mlp(params["pi"], obs)
    mu, log_std = out.chunk(2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    if eps is None:
        eps = torch.randn(mu.shape, generator=gen, device=mu.device)
    pre = mu + std * eps
    a = torch.tanh(pre)
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + np.log(2 * np.pi))
        - torch.log(1 - a ** 2 + 1e-6), dim=-1)
    return a, logp


def q_values(params, obs, act):
    x = torch.cat([obs, act], dim=-1)
    return _mlp(params["q1"], x)[..., 0], _mlp(params["q2"], x)[..., 0]


def critic_loss(params, target_q, log_alpha, batch: dict, gamma: float,
                eps: torch.Tensor) -> torch.Tensor:
    """Twin-Q TD loss against the target critics' soft value of the
    next state (the target carries no gradient)."""
    with torch.no_grad():
        next_a, next_logp = sample_action(params, batch["next_obs"],
                                          eps=eps)
        tq1, tq2 = q_values(target_q, batch["next_obs"], next_a)
        alpha = torch.exp(log_alpha)
        target = batch["rewards"] + gamma * (1 - batch["dones"]) * (
            torch.minimum(tq1, tq2) - alpha * next_logp)
    q1, q2 = q_values(params, batch["obs"], batch["actions"])
    return torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)


def actor_loss(params, log_alpha, batch: dict, eps: torch.Tensor):
    """(mean(alpha logp - min Q), logp) at fresh actions of the
    policy."""
    a, logp = sample_action(params, batch["obs"], eps=eps)
    q1, q2 = q_values(params, batch["obs"], a)
    alpha = torch.exp(log_alpha).detach()
    return torch.mean(alpha * logp - torch.minimum(q1, q2)), logp


@dataclasses.dataclass
class SACConfig(AlgorithmConfig):
    env: str = "Pendulum-v1"
    num_envs: int = 8
    rollout_fragment_length: int = 8
    tau: float = 0.005  # polyak
    buffer_capacity: int = 100_000
    train_batch_size: int = 256
    num_steps_sampled_before_learning: int = 1500
    updates_per_iteration: int = 16
    hidden: tuple = (256, 256)
    initial_alpha: float = 1.0
    target_entropy: float | None = None  # default: -act_dim

    def build(self) -> "SAC":
        return SAC(self)


class SAC(Algorithm):
    config_class = SACConfig
    STATE_COMPONENTS = ("params", "target_q", "log_alpha",
                        "_env_steps", "_iteration", "_timesteps_total")

    def setup(self, config: SACConfig):
        if config.evaluation_interval:
            raise ValueError(
                "SAC has no separate evaluation runner — "
                "episode_return_mean from training IS the "
                "evaluation surface; unset evaluation_interval")
        cfg = config
        self.envs = _envs.make_vec(cfg.env, cfg.num_envs)
        space = self.envs.single_action_space
        self.obs_dim = int(np.prod(self.envs.single_observation_space.shape))
        self.act_dim = int(np.prod(space.shape))
        self._act_low = np.asarray(space.low, np.float32)
        self._act_high = np.asarray(space.high, np.float32)
        self.target_entropy = (cfg.target_entropy
                               if cfg.target_entropy is not None
                               else -float(self.act_dim))

        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        self.params = init_sac_params(gen, self.obs_dim, self.act_dim,
                                      cfg.hidden, device=self.device)
        self.target_q = {"q1": tree.tree_map(torch.clone, self.params["q1"]),
                         "q2": tree.tree_map(torch.clone, self.params["q2"])}
        self.log_alpha = torch.tensor(np.log(cfg.initial_alpha),
                                      dtype=torch.float32, device=self.device)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self.alpha_tx = adam(cfg.lr)
        self.alpha_opt = self.alpha_tx.init(self.log_alpha)
        self.buffer = PrioritizedReplayBuffer(cfg.buffer_capacity,
                                              alpha=0.0, seed=cfg.seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed + 1)
        self.obs, _ = self.envs.reset(seed=cfg.seed)
        # next-step autoreset: the step after done has an ignored action
        # and bridges two episodes — never store it (it would poison the
        # replay buffer with fabricated transitions)
        self._prev_done = np.zeros(cfg.num_envs, np.bool_)
        self._ep_returns = np.zeros(cfg.num_envs)
        self._completed: list[float] = []
        self._env_steps = 0

    def _noise(self, n: int) -> torch.Tensor:
        return torch.randn((n, self.act_dim), generator=self._gen,
                           device=self.device)

    def _update(self, batch: dict, eps_critic=None, eps_actor=None):
        """One critic + actor + temperature step and the Polyak targets
        on a batch of device tensors; `eps_critic` and `eps_actor` are
        the noise of the next-state and the actor's actions (drawn
        from the algorithm's generator when not given). Returns the
        critic and actor losses as 0-d device tensors."""
        cfg = self.config
        n = batch["obs"].shape[0]
        eps_c = self._noise(n) if eps_critic is None else eps_critic
        eps_a = self._noise(n) if eps_actor is None else eps_actor
        for p in tree.leaves(self.params):
            p.requires_grad_(True)
        q_leaves = tree.leaves(self.params["q1"]) + \
            tree.leaves(self.params["q2"])
        pi_leaves = tree.leaves(self.params["pi"])
        c_loss = critic_loss(self.params, self.target_q, self.log_alpha,
                             batch, cfg.gamma, eps_c)
        c_grads = torch.autograd.grad(c_loss, q_leaves)
        a_loss, logp = actor_loss(self.params, self.log_alpha, batch, eps_a)
        a_grads = torch.autograd.grad(a_loss, pi_leaves)
        # actor grads touch only pi; critic grads touch only q1/q2 —
        # merged per subtree so each step is its textbook update
        grads = {"pi": tree.unflatten(self.params["pi"], a_grads),
                 "q1": tree.unflatten(self.params["q1"],
                                      c_grads[:len(q_leaves) // 2]),
                 "q2": tree.unflatten(self.params["q2"],
                                      c_grads[len(q_leaves) // 2:])}
        self.params, self.opt_state = self.tx.update(
            grads, self.opt_state, self.params)
        # temperature: push entropy toward the target
        al_grad = -torch.mean(logp.detach() + self.target_entropy)
        self.log_alpha, self.alpha_opt = self.alpha_tx.update(
            al_grad, self.alpha_opt, self.log_alpha)
        with torch.no_grad():
            for k in ("q1", "q2"):
                t, o = tree.leaves(self.target_q[k]), \
                    tree.leaves(self.params[k])
                torch._foreach_mul_(t, 1 - cfg.tau)
                torch._foreach_add_(t, o, alpha=cfg.tau)
        return c_loss.detach(), a_loss.detach()

    def _scale(self, a: np.ndarray) -> np.ndarray:
        return self._act_low + (a + 1.0) * 0.5 * (self._act_high -
                                                  self._act_low)

    def training_step(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        for _ in range(cfg.rollout_fragment_length):
            with torch.no_grad():
                obs = torch.from_numpy(
                    self.obs.astype(np.float32)).to(self.device)
                a, _ = sample_action(self.params, obs, self._gen)
                a = a.cpu().numpy()
            nxt, rew, term, trunc, _ = self.envs.step(self._scale(a))
            done = np.logical_or(term, trunc)
            valid = ~self._prev_done
            if valid.any():
                self.buffer.add_batch({
                    "obs": self.obs[valid].astype(np.float32),
                    "actions": a[valid],
                    "rewards": np.asarray(rew, np.float32)[valid],
                    "next_obs": nxt[valid].astype(np.float32),
                    # truncation bootstraps
                    "dones": term[valid].astype(np.float32),
                })
            self._prev_done = done
            self._ep_returns += rew
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self.obs = nxt
            self._env_steps += cfg.num_envs

        losses = []
        if len(self.buffer) >= cfg.num_steps_sampled_before_learning:
            for _ in range(cfg.updates_per_iteration):
                batch = self.buffer.sample(cfg.train_batch_size)
                batch.pop("idxs")
                batch.pop("weights")
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                losses.append(torch.stack(self._update(batch)))
        # one host copy of the iteration's losses
        cl, al = (torch.stack(losses).mean(0).cpu().tolist() if losses
                  else (float("nan"), float("nan")))

        window = self._completed[-100:]
        self._completed = window
        dt = time.perf_counter() - t0
        return {
            "episode_return_mean": float(np.mean(window)) if window
            else float("nan"),
            "num_env_steps_sampled_lifetime": self._env_steps,
            "env_steps_per_sec": cfg.rollout_fragment_length *
            cfg.num_envs / dt,
            "alpha": float(torch.exp(self.log_alpha)),
            "learner/critic_loss": cl,
            "learner/actor_loss": al,
        }

    def get_weights(self):
        return params_to_numpy(self.params)

    def evaluate(self) -> dict:
        # SAC's env loop is continuous-action and lives in the driver —
        # the base's discrete eval runner does not apply
        raise NotImplementedError(
            "SAC evaluation rides episode_return_mean from training")

    def cleanup(self):
        self.envs.close()
