"""SingleAgentEnvRunner — vectorized env sampling with policy inference:
the port of ``ray_tpu/rllib/env_runner.py``.

Reference parity: rllib/env/single_agent_env_runner.py:64 (`sample`
:139, hot loop `_sample` :243): vector envs stepped against the current
RLModule. The envs are the port's own (`rllib/envs.py`), and the module
runs on the runner's device (the card unless the caller passes
another): each env step moves the observations to the device once and
brings ``(action, logp, value)`` back in one copy, one host sync a
step. Collected rollouts come back as flat numpy arrays.

The runners run in this process: `EnvRunnerGroup` with
``num_env_runners > 0`` would make them actors, and the port has no
runtime yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.connectors import default_env_to_module
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.device import resolve_device


def copy_weights_(params, weights) -> None:
    """Copy a tree of host arrays (or tensors) into `params`' tensors in
    place, leaf by leaf (a replicated DTensor's local tensor is the
    whole one)."""
    with torch.no_grad():
        for p, w in zip(tree.leaves(params), tree.leaves(weights),
                        strict=True):
            dst = p.to_local() if isinstance(p, DTensor) else p
            dst.copy_(w if isinstance(w, torch.Tensor)
                      else torch.from_numpy(np.asarray(w)))


class SingleAgentEnvRunner:
    """Samples fragments from a vector env with the current weights."""

    def __init__(self, env: str = "CartPole-v1", num_envs: int = 1,
                 rollout_fragment_length: int = 200, seed: int = 0,
                 hidden=(64, 64), framestack: int = 1,
                 model_config: dict | None = None,
                 module_spec=None, device=None):
        self.device = resolve_device(device)
        self.envs = _envs.make_vec(env, num_envs)
        self.num_envs = num_envs
        self.T = rollout_fragment_length
        raw_shape = tuple(self.envs.single_observation_space.shape)
        self.n_actions = int(self.envs.single_action_space.n)

        # env→module connector pipeline (reference: connector_v2.py:31);
        # image obs get normalize(+framestack), vectors get flatten —
        # the module sees the PROCESSED shape everywhere (buffers, nets)
        self.pipeline = default_env_to_module(raw_shape, framestack)
        self.pipeline.reset(num_envs)
        self.obs_shape = self.pipeline.output_shape(raw_shape)
        self.obs_dim = int(np.prod(self.obs_shape))  # legacy vector algos
        self._image = len(self.obs_shape) == 3

        mc = dict(model_config or {})
        mc.setdefault("hidden", tuple(hidden))
        # RLModule seam (reference: the runner builds its module from an
        # RLModuleSpec, single_agent_env_runner.py make_module): default
        # is the catalog actor-critic; algorithms may ship a custom spec
        if module_spec is None:
            module_spec = RLModuleSpec(
                obs_spec=self.obs_shape if self._image else self.obs_dim,
                n_actions=self.n_actions, model_config=mc)
        self.module = module_spec.build(device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = self.module.init(gen)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        raw_obs, _ = self.envs.reset(seed=seed)
        self.obs = self.pipeline(raw_obs)
        self._ep_returns = np.zeros(num_envs)
        self._completed_returns: list[float] = []
        self._env_steps_total = 0
        # NEXT-STEP autoreset: the obs returned on the step AFTER done is
        # a reset frame (and that step's action is ignored). Carried
        # across fragments for reset_mask correctness.
        self._last_done = np.zeros(num_envs, np.bool_)

    # -- weights ---------------------------------------------------------

    def set_weights(self, weights) -> bool:
        """Weights arrive as host numpy trees (reference:
        EnvRunnerGroup.sync_weights broadcast); they are copied into the
        runner's tensors on its device."""
        copy_weights_(self.params, weights)
        return True

    def get_weights(self):
        return tree.tree_map(
            lambda t: t.detach().to("cpu", copy=True).numpy(), self.params)

    # -- sampling --------------------------------------------------------

    @torch.no_grad()
    def _explore(self, obs: np.ndarray):
        """(action, logp, value) for a host batch of observations: one
        copy to the device, one copy of the three rows back."""
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        action, logp, value = self.module.explore(self.params, x, self._gen)
        out = torch.stack([action.to(logp.dtype), logp, value]).cpu()
        out = out.numpy()
        return out[0].astype(np.int64), out[1], out[2]

    def sample(self) -> dict:
        """One rollout fragment of T steps across all envs. Returns flat
        (T*num_envs, ...) arrays plus bootstrap values, and episode-return
        stats for completed episodes."""
        T, N = self.T, self.num_envs
        obs_buf = np.empty((T, N, *self.obs_shape), np.float32)
        act_buf = np.empty((T, N), np.int64)
        logp_buf = np.empty((T, N), np.float32)
        val_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), np.bool_)
        # reset_mask[t]: the obs at step t is an autoreset frame — the
        # env IGNORED that step's action (next-step autoreset), so the
        # transition is not real experience and learners must drop it
        reset_buf = np.empty((T, N), np.bool_)

        obs = self.obs
        for t in range(T):
            action, logp, value = self._explore(obs)
            raw_next, reward, term, trunc, _ = self.envs.step(action)
            done = np.logical_or(term, trunc)
            obs_buf[t] = obs
            act_buf[t] = action
            logp_buf[t] = logp
            val_buf[t] = value
            rew_buf[t] = reward
            done_buf[t] = done
            reset_buf[t] = self._last_done
            self._ep_returns += reward
            for i in np.nonzero(done)[0]:
                self._completed_returns.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            # next-step autoreset timeline: the done step returns the
            # FINAL frame (shift it in — it belongs to the old episode);
            # the RESET frame arrives one iteration later, i.e. raw_next
            # is a fresh frame exactly where the PREVIOUS step was done.
            obs = self.pipeline(raw_next, dones=self._last_done)
            self._last_done = done
        self.obs = obs
        self._env_steps_total += T * N
        # bootstrap value for the final observation of each env
        _, _, last_val = self._explore(obs)
        completed = self._completed_returns[-100:]
        self._completed_returns = completed  # keep a sliding window
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "reset_mask": reset_buf,
            "last_values": last_val,
            "episode_return_mean": float(np.mean(completed)) if completed
            else float("nan"),
            "num_episodes": len(completed),
            "env_steps": T * N,
        }


class EnvRunnerGroup:
    """The env runners of an algorithm (reference:
    rllib/env/env_runner_group.py:71 — foreach/weight sync). Only the
    local runner exists in the port: remote runners are actors, and the
    port has no runtime yet."""

    def __init__(self, num_env_runners: int = 1, remote: bool = True,
                 **runner_kwargs):
        if remote and num_env_runners > 0:
            raise ValueError(
                f"num_env_runners={num_env_runners}: remote env runners "
                "are actors, and ray_tpu_torch has no runtime yet; pass "
                "num_env_runners=0 to sample with the local runner")
        self.local = SingleAgentEnvRunner(**runner_kwargs)

    def sample(self) -> list[dict]:
        return [self.local.sample()]

    def sync_weights(self, weights):
        """Copy the learner's weights into the local runner."""
        self.local.set_weights(weights)

    def shutdown(self):
        self.local.envs.close()
