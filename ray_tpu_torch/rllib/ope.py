"""Off-policy evaluation over logged experiences: the port of
``ray_tpu/rllib/ope.py``.

Reference parity: rllib/offline/estimators — ImportanceSampling,
WeightedImportanceSampling (is/wis.py), and the doubly-robust family
(doubly_robust.py). Estimators consume episode rows
(obs/action/reward/done/truncated/logp): the logged `logp` is the
behavior policy's action log-probability, and the TARGET policy is a
params tree evaluated with the functional model (`models.forward`) in
one batched pass on the estimator's device (the card unless the caller
names another), no environment interaction. The rows are in memory: reading a recorded dataset waits
for the port's data layer.

Estimates follow the per-decision formulation:
  IS :  V = E_ep [ sum_t gamma^t * rho_{0:t} * r_t ]
  WIS:  same, but rho_{0:t} is normalized per t by its mean over
        episodes (self-normalized weights — lower variance, small bias)
  DR :  V = E_ep [ V_hat(s_0) + sum_t gamma^t * rho_{0:t} *
              (r_t + gamma * V_hat(s_{t+1}) - V_hat(s_t)) ]
        with the target policy's value head as the state baseline.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib import models
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.device import resolve_device


def split_episodes(rows: list[dict]) -> list[list[dict]]:
    """Env-major row stream -> list of trajectories (cut at done or
    truncated — a truncated tail is still a usable partial episode)."""
    episodes: list[list[dict]] = []
    cur: list[dict] = []
    for r in rows:
        cur.append(r)
        if r.get("done") or r.get("truncated"):
            episodes.append(cur)
            cur = []
    if cur:
        episodes.append(cur)
    return episodes


@torch.no_grad()
def _target_logp_and_values(params, episodes):
    """One batched forward over every logged step where the params lie:
    per-episode arrays of target-policy log-probs and state values."""
    device = tree.leaves(params)[0].device
    obs = torch.from_numpy(np.asarray(
        [r["obs"] for ep in episodes for r in ep], np.float32)).to(device)
    acts = torch.from_numpy(np.asarray(
        [r["action"] for ep in episodes for r in ep], np.int64)).to(device)
    logits, values = models.forward(params, obs)
    logp = torch.log_softmax(logits, -1).gather(1, acts[:, None])[:, 0]
    logp, values = torch.stack([logp, values]).cpu().numpy()
    out_logp, out_v, i = [], [], 0
    for ep in episodes:
        out_logp.append(logp[i:i + len(ep)])
        out_v.append(values[i:i + len(ep)])
        i += len(ep)
    return out_logp, out_v


class OffPolicyEstimator:
    """Base (reference: offline/estimators/off_policy_estimator.py).
    `params` is a tree of tensors or of host arrays (a ``get_weights()``);
    the target policy runs on `device`, "cuda" unless the caller names
    another, and raises there without a card."""

    def __init__(self, params, gamma: float = 0.99, device=None):
        dev = resolve_device(device)
        self.params = tree.tree_map(
            lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev),
            params)
        self.gamma = gamma

    def estimate(self, rows: list[dict]) -> dict:
        episodes = [ep for ep in split_episodes(rows) if ep]
        if not episodes:
            return {"v_target": float("nan"),
                    "v_behavior": float("nan"), "v_gain": float("nan")}
        t_logp, t_val = _target_logp_and_values(self.params, episodes)
        g = self.gamma
        v_behavior = float(np.mean([
            sum(g ** t * r["reward"] for t, r in enumerate(ep))
            for ep in episodes]))
        v_target = self._estimate(episodes, t_logp, t_val)
        return {
            "v_target": float(v_target),
            "v_behavior": v_behavior,
            "v_gain": float(v_target / v_behavior) if v_behavior else
            float("nan"),
            "num_episodes": len(episodes),
        }

    # rho_{0:t} per episode, clipped for numeric sanity
    def _cum_rhos(self, episodes, t_logp, clip: float = 1e3):
        out = []
        for ep, tl in zip(episodes, t_logp):
            beh = np.asarray([r["logp"] for r in ep], np.float64)
            rho = np.exp(np.cumsum(tl.astype(np.float64) - beh))
            out.append(np.clip(rho, 0.0, clip))
        return out

    def _estimate(self, episodes, t_logp, t_val) -> float:
        raise NotImplementedError


class ImportanceSampling(OffPolicyEstimator):
    """Per-decision ordinary IS (reference: estimators/is.py)."""

    def _estimate(self, episodes, t_logp, t_val) -> float:
        g = self.gamma
        vals = []
        for ep, rho in zip(episodes, self._cum_rhos(episodes, t_logp)):
            vals.append(sum(g ** t * rho[t] * r["reward"]
                            for t, r in enumerate(ep)))
        return float(np.mean(vals))


class WeightedImportanceSampling(OffPolicyEstimator):
    """Self-normalized per-decision IS (reference: estimators/wis.py):
    rho_{0:t} divided by its mean over episodes at each t."""

    def _estimate(self, episodes, t_logp, t_val) -> float:
        g = self.gamma
        rhos = self._cum_rhos(episodes, t_logp)
        T = max(len(ep) for ep in episodes)
        # mean weight per timestep over the episodes still alive at t
        denom = np.array([
            np.mean([rho[t] for rho in rhos if len(rho) > t]) or 1.0
            for t in range(T)])
        vals = []
        for ep, rho in zip(episodes, rhos):
            vals.append(sum(
                g ** t * (rho[t] / max(denom[t], 1e-12)) * r["reward"]
                for t, r in enumerate(ep)))
        return float(np.mean(vals))


class DoublyRobust(OffPolicyEstimator):
    """DR with the target value head as state baseline (reference:
    estimators/doubly_robust.py; Jiang & Li 2016 with V as the control
    variate): exact when either the weights or the baseline are right,
    lower variance than IS when the baseline is decent."""

    def _estimate(self, episodes, t_logp, t_val) -> float:
        g = self.gamma
        vals = []
        for ep, rho, v in zip(episodes,
                              self._cum_rhos(episodes, t_logp), t_val):
            total = float(v[0])
            for t, r in enumerate(ep):
                terminal = bool(r.get("done"))
                v_next = 0.0 if (terminal or t + 1 >= len(ep)) \
                    else float(v[t + 1])
                td = r["reward"] + g * v_next - float(v[t])
                total += g ** t * rho[t] * td
            vals.append(total)
        return float(np.mean(vals))
