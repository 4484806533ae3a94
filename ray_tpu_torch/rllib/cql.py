"""CQL — Conservative Q-Learning for offline continuous control: the port
of ``ray_tpu/rllib/cql.py``.

Reference parity: rllib/algorithms/cql/cql.py:1 (CQLConfig extends
SACConfig; the learner adds the conservative regularizer to the SAC
critic loss) and cql/torch/cql_torch_learner.py (logsumexp over
sampled random + policy actions minus dataset-action Q). Built on the
port's SAC networks (rllib/sac.py) and offline data plumbing
(rllib/offline.py): one update performs the critic, actor and
temperature steps on the algorithm's device, the action-sampling
fan-out one (B * 3N, ·) batch through each critic.

CQL(H) lower-bounds Q under distribution shift: the critic minimizes
  bellman_mse + cql_alpha * (E_s[logsumexp_a Q(s,a)] - E_(s,a)~D[Q(s,a)])
so out-of-distribution actions get pushed DOWN relative to dataset
actions — the property the tests assert directly.

Where JAX splits a key, the port draws from the algorithm's seeded
`torch.Generator` on its device; every draw of the critic's loss (the
next-state noise, the uniform out-of-distribution actions, the policy
samples' noise) and the actor's noise can also be passed in as tensors,
so a test can pass the draws of JAX's keys. The recorder steps the
port's own Pendulum-v1 (``rllib/envs.py``), as gymnasium's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.sac import (_mlp, actor_loss, init_sac_params,
                                     q_values, sample_action)
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.util import tree


def _single_env(env: str):
    """One env of `env` with gymnasium's single-env face (`reset`
    seeds it, `step` truncates at its time limit and never resets on
    its own), as ``gym.make(env)`` builds it: the lane of its vector
    env."""
    return _envs.make_vec(env, 1).envs[0]


def record_continuous_experiences(env: str, num_steps: int, out_dir: str,
                                  seed: int = 0, fmt: str = "jsonl"):
    """Roll a uniform-random policy through a continuous-action env and
    persist normalized transitions (actions mapped to [-1,1], matching
    the tanh-squashed convention) as a ray_tpu_torch.data dataset
    (reference: offline recording via output_config)."""
    from ray_tpu_torch import data as rd

    e = _single_env(env)
    low = np.asarray(e.action_space.low, np.float32)
    high = np.asarray(e.action_space.high, np.float32)
    rng = np.random.default_rng(seed)
    rows = []
    obs, _ = e.reset(seed=seed)
    for _ in range(num_steps):
        a_norm = rng.uniform(-1.0, 1.0, size=low.shape).astype(np.float32)
        a_env = low + (a_norm + 1.0) * 0.5 * (high - low)
        nxt, rew, term, trunc, _ = e.step(a_env)
        rows.append({
            "obs": [float(x) for x in np.reshape(obs, -1)],
            "action": [float(x) for x in a_norm],
            "reward": float(rew),
            "next_obs": [float(x) for x in np.reshape(nxt, -1)],
            "done": bool(term),
        })
        obs = nxt
        if term or trunc:
            obs, _ = e.reset()
    e.close()
    ds = rd.from_items(rows, parallelism=8)
    if fmt == "parquet":
        return ds.write_parquet(out_dir)
    return ds.write_jsonl(out_dir)


@dataclasses.dataclass
class CQLConfig(AlgorithmConfig):
    """Reference: CQLConfig (cql.py) = SACConfig + conservative knobs;
    rides the shared AlgorithmConfig (env = evaluation env)."""

    input_path: str = ""
    env: str = "Pendulum-v1"  # evaluation env
    tau: float = 0.005
    train_batch_size: int = 256
    updates_per_iteration: int = 32
    hidden: tuple = (256, 256)
    initial_alpha: float = 1.0
    target_entropy: float | None = None
    # conservative regularizer (reference: cql.py min_q_weight role)
    cql_alpha: float = 5.0
    n_action_samples: int = 4

    def offline_data(self, input_path: str) -> "CQLConfig":
        self.input_path = input_path
        return self

    def build(self) -> "CQL":
        return CQL(self)


def _q_fanout_cat(params, obs, actions):
    """Q(s, a_i) for B obs x M sampled actions each: broadcast to
    (B*M, ·) so each critic runs one batch of products."""
    B, M = actions.shape[0], actions.shape[1]
    obs_rep = torch.repeat_interleave(obs, M, dim=0)
    q1, q2 = q_values(params, obs_rep, actions.reshape(B * M, -1))
    return q1.reshape(B, M), q2.reshape(B, M)


def critic_loss(params, target_q, log_alpha, batch: dict, gamma: float,
                cql_alpha: float, eps_next, rand_a, eps_pol, eps_nxt):
    """(bellman + cql_alpha * gap, (bellman, gap)). `eps_next` is the
    next-state action's noise (B, A); `rand_a` the uniform actions in
    [-1, 1) (B, N, A); `eps_pol` and `eps_nxt` the noise of the N policy
    samples at each state and next state (B * N, A)."""
    B, N, act_dim = rand_a.shape
    with torch.no_grad():
        # SAC bellman target
        next_a, next_logp = sample_action(params, batch["next_obs"],
                                          eps=eps_next)
        tin = torch.cat([batch["next_obs"], next_a], -1)
        tq = torch.minimum(_mlp(target_q["q1"], tin)[..., 0],
                           _mlp(target_q["q2"], tin)[..., 0])
        alpha = torch.exp(log_alpha)
        target = batch["rewards"] + gamma * (1 - batch["dones"]) * (
            tq - alpha * next_logp)
    q1, q2 = q_values(params, batch["obs"], batch["actions"])
    bellman = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
    # conservative term: logsumexp over random + policy actions
    with torch.no_grad():
        pol_a, pol_logp = sample_action(
            params, torch.repeat_interleave(batch["obs"], N, dim=0),
            eps=eps_pol)
        nxt_a, nxt_logp = sample_action(
            params, torch.repeat_interleave(batch["next_obs"], N, dim=0),
            eps=eps_nxt)
    # importance corrections (reference: cql_torch_learner.py): uniform
    # density 0.5^d for random, detached logp for policy
    log_u = act_dim * np.log(0.5)
    corr = torch.cat([
        torch.full((B, N), log_u, dtype=q1.dtype, device=q1.device),
        pol_logp.reshape(B, N), nxt_logp.reshape(B, N)], dim=1)
    cat = torch.cat([rand_a, pol_a.reshape(B, N, -1),
                     nxt_a.reshape(B, N, -1)], dim=1)
    cq1, cq2 = _q_fanout_cat(params, batch["obs"], cat)
    gap1 = torch.mean(torch.logsumexp(cq1 - corr, dim=1)) - torch.mean(q1)
    gap2 = torch.mean(torch.logsumexp(cq2 - corr, dim=1)) - torch.mean(q2)
    return bellman + cql_alpha * (gap1 + gap2), (bellman, gap1 + gap2)


class CQL(Algorithm):
    """Conservative Q-learning on the shared Algorithm base (offline:
    no sampling env; `evaluate(...)` takes the env explicitly)."""

    config_class = CQLConfig
    STATE_COMPONENTS = ("params", "target_q", "log_alpha", "_iteration",
                        "_timesteps_total")

    def setup(self, config: CQLConfig):
        from ray_tpu_torch.rllib.offline import load_offline_dataset

        cfg = config
        rows = load_offline_dataset(cfg.input_path).take_all()
        if not rows:
            raise ValueError(f"no offline rows at {cfg.input_path!r}")
        data = {
            "obs": np.asarray([r["obs"] for r in rows], np.float32),
            "actions": np.asarray([r["action"] for r in rows], np.float32),
            "rewards": np.asarray([r["reward"] for r in rows], np.float32),
            "next_obs": np.asarray([r["next_obs"] for r in rows],
                                   np.float32),
            "dones": np.asarray([float(r["done"]) for r in rows],
                                np.float32),
        }
        self._data = {k: torch.from_numpy(v).to(self.device)
                      for k, v in data.items()}
        self.obs_dim = data["obs"].shape[1]
        self.act_dim = data["actions"].shape[1]
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
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed + 1)
        self._rng = np.random.default_rng(cfg.seed)

    def _normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _update(self, batch: dict, eps_next=None, rand_a=None,
                eps_pol=None, eps_nxt=None, eps_actor=None):
        """One critic + actor + temperature step and the Polyak targets
        on a batch of device tensors; each draw not given comes from the
        algorithm's generator. Returns the Bellman loss, the
        conservative gap and the actor loss as 0-d device tensors."""
        cfg = self.config
        B, A, N = batch["obs"].shape[0], self.act_dim, cfg.n_action_samples
        if eps_next is None:
            eps_next = self._normal(B, A)
        if rand_a is None:
            rand_a = torch.rand((B, N, A), generator=self._gen,
                                device=self.device) * 2.0 - 1.0
        if eps_pol is None:
            eps_pol = self._normal(B * N, A)
        if eps_nxt is None:
            eps_nxt = self._normal(B * N, A)
        if eps_actor is None:
            eps_actor = self._normal(B, A)
        for p in tree.leaves(self.params):
            p.requires_grad_(True)
        q_leaves = tree.leaves(self.params["q1"]) + \
            tree.leaves(self.params["q2"])
        pi_leaves = tree.leaves(self.params["pi"])
        c_loss, (bellman, gap) = critic_loss(
            self.params, self.target_q, self.log_alpha, batch, cfg.gamma,
            cfg.cql_alpha, eps_next, rand_a, eps_pol, eps_nxt)
        c_grads = torch.autograd.grad(c_loss, q_leaves)
        a_loss, logp = actor_loss(self.params, self.log_alpha, batch,
                                  eps_actor)
        a_grads = torch.autograd.grad(a_loss, pi_leaves)
        grads = {"pi": tree.unflatten(self.params["pi"], a_grads),
                 "q1": tree.unflatten(self.params["q1"],
                                      c_grads[:len(q_leaves) // 2]),
                 "q2": tree.unflatten(self.params["q2"],
                                      c_grads[len(q_leaves) // 2:])}
        self.params, self.opt_state = self.tx.update(
            grads, self.opt_state, self.params)
        al_grad = -torch.mean(logp.detach() + self.target_entropy)
        self.log_alpha, self.alpha_opt = self.alpha_tx.update(
            al_grad, self.alpha_opt, self.log_alpha)
        with torch.no_grad():
            for k in ("q1", "q2"):
                t, o = tree.leaves(self.target_q[k]), \
                    tree.leaves(self.params[k])
                torch._foreach_mul_(t, 1 - cfg.tau)
                torch._foreach_add_(t, o, alpha=cfg.tau)
        return bellman.detach(), gap.detach(), a_loss.detach()

    def _minibatch(self) -> dict:
        n = len(self._data["rewards"])
        idx = self._rng.integers(0, n, min(self.config.train_batch_size, n))
        idx = torch.from_numpy(idx).to(self.device)
        return {k: v[idx] for k, v in self._data.items()}

    def training_step(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        out = [torch.stack(self._update(self._minibatch()))
               for _ in range(cfg.updates_per_iteration)]
        # one host copy of the iteration's losses
        bellman, gap, a_loss = torch.stack(out).mean(0).cpu().tolist()
        return {
            "learner/bellman_loss": bellman,
            "learner/conservative_gap": gap,
            "learner/actor_loss": a_loss,
            "alpha": float(torch.exp(self.log_alpha)),
            "time_s": time.perf_counter() - t0,
        }

    @torch.no_grad()
    def ood_gap(self, n: int = 512) -> float:
        """Mean Q advantage of DATASET actions over random (OOD) actions
        — positive once the conservative penalty bites; the defining
        CQL property, asserted by tests."""
        idx = self._rng.integers(0, len(self._data["rewards"]), n)
        idx = torch.from_numpy(idx).to(self.device)
        obs, acts = self._data["obs"][idx], self._data["actions"][idx]
        rand = torch.from_numpy(self._rng.uniform(
            -1, 1, tuple(acts.shape)).astype(np.float32)).to(self.device)
        q_data = torch.minimum(*q_values(self.params, obs, acts))
        q_rand = torch.minimum(*q_values(self.params, obs, rand))
        return float(torch.mean(q_data) - torch.mean(q_rand))

    @torch.no_grad()
    def evaluate(self, env: str | None = None,
                 num_episodes: int = 5) -> dict:
        """Deterministic (tanh-mean) policy rollout."""
        e = _single_env(env or self.config.env)
        low = np.asarray(e.action_space.low, np.float32)
        high = np.asarray(e.action_space.high, np.float32)
        returns = []
        for ep in range(num_episodes):
            obs, _ = e.reset(seed=2000 + ep)
            total, done = 0.0, False
            while not done:
                x = torch.from_numpy(
                    np.asarray(obs, np.float32).reshape(1, -1))
                mu, _ = _mlp(self.params["pi"], x.to(self.device)).chunk(
                    2, dim=-1)
                a = torch.tanh(mu)[0].cpu().numpy()
                a_env = low + (a + 1.0) * 0.5 * (high - low)
                obs, r, term, trunc, _ = e.step(a_env)
                total += float(r)
                done = term or trunc
            returns.append(total)
        e.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": num_episodes}

    def get_weights(self):
        return params_to_numpy(self.params)
