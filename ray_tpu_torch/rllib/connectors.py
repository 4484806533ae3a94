"""Connector pipelines — env→module and learner-side batch transforms:
the port's copy of ``ray_tpu/rllib/connectors.py`` (numpy).

Reference parity: ConnectorV2 (rllib/connectors/connector_v2.py:31) and
the pipeline container (connector_pipeline_v2.py): small composable
pieces that reshape raw env observations into module inputs
(frame-stacking, normalization, flattening) and enrich train batches in
the learner (GAE — rllib/connectors/learner/
general_advantage_estimation.py). Functional numpy on the env side
(runs in the env runner per step), the learner connector feeds the
learner's update.
"""

from __future__ import annotations

import numpy as np


class ConnectorV2:
    """One batch transform. Env-side connectors receive the vectorized
    observation batch (N, ...) plus the `dones` mask from the previous
    step so stateful connectors (FrameStack) can reset per-env state."""

    def __call__(self, obs: np.ndarray, dones=None) -> np.ndarray:
        raise NotImplementedError

    def output_shape(self, in_shape: tuple) -> tuple:
        return tuple(in_shape)

    def reset(self, num_envs: int):
        """Called once when the vector env is (re)built."""


class ConnectorPipeline(ConnectorV2):
    """Reference: ConnectorPipelineV2 — connectors applied in order."""

    def __init__(self, connectors):
        self.connectors = list(connectors)

    def __call__(self, obs, dones=None):
        for c in self.connectors:
            obs = c(obs, dones)
        return obs

    def output_shape(self, in_shape):
        for c in self.connectors:
            in_shape = c.output_shape(in_shape)
        return tuple(in_shape)

    def reset(self, num_envs: int):
        for c in self.connectors:
            c.reset(num_envs)


class NormalizeImage(ConnectorV2):
    """uint8 pixels -> float32 in [0, 1] (the standard Atari prep)."""

    def __call__(self, obs, dones=None):
        return np.asarray(obs, np.float32) / 255.0


class FlattenObs(ConnectorV2):
    def __call__(self, obs, dones=None):
        return np.asarray(obs, np.float32).reshape(obs.shape[0], -1)

    def output_shape(self, in_shape):
        return (int(np.prod(in_shape)),)


class FrameStack(ConnectorV2):
    """Stack the last k frames on the channel axis (reference:
    the frame-stacking connector used by the Atari PPO benchmark,
    rllib/examples/connectors/frame_stacking.py). Per-env state, aware
    of gymnasium's NEXT-STEP autoreset: the step where done=True still
    returns the ending episode's final frame (shifted in normally); the
    fresh reset frame arrives one step later, and THAT is where the done
    env's stack restarts — `dones` is the previous step's done mask, so
    it marks exactly the envs whose current obs is a reset frame."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stacks = None  # (N, H, W, C*k)

    def reset(self, num_envs: int):
        self._stacks = None

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs)
        n, h, w, c = obs.shape
        # frame-major layout [f0|f1|...]: np.tile repeats WHOLE frames,
        # matching the shift path; np.repeat would interleave channels
        # and scramble multi-channel stacks
        if self._stacks is None or self._stacks.shape[0] != n:
            self._stacks = np.tile(obs, (1, 1, 1, self.k))
        else:
            shifted = np.concatenate([self._stacks[..., c:], obs], axis=-1)
            if dones is not None and dones.any():
                # obs[dones] is the new episode's FIRST frame (next-step
                # autoreset): restart those stacks, don't mix episodes
                shifted[dones] = np.tile(obs[dones], (1, 1, 1, self.k))
            self._stacks = shifted
        return self._stacks.copy()

    def output_shape(self, in_shape):
        h, w, c = in_shape
        return (h, w, c * self.k)


def default_env_to_module(obs_shape, framestack: int = 1):
    """Default pipeline by obs space (reference: the default
    env-to-module connector assembly, connector_pipeline_v2.py)."""
    if len(obs_shape) == 3:
        pipe = [NormalizeImage()]
        if framestack > 1:
            pipe.append(FrameStack(framestack))
        return ConnectorPipeline(pipe)
    return ConnectorPipeline([FlattenObs()])


class GeneralAdvantageEstimation:
    """Learner connector: adds advantages/value_targets to a rollout
    sample (reference:
    rllib/connectors/learner/general_advantage_estimation.py)."""

    def __init__(self, gamma: float, lambda_: float):
        self.gamma = gamma
        self.lambda_ = lambda_

    def __call__(self, sample: dict) -> dict:
        from ray_tpu_torch.rllib.learner import compute_gae

        adv, targets = compute_gae(
            sample["rewards"], sample["values"], sample["dones"],
            sample["last_values"], self.gamma, self.lambda_)
        out = dict(sample)
        out["advantages"] = adv
        out["value_targets"] = targets
        return out
