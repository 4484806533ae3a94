"""Run configuration: the port's copies of `RunConfig` and
`FailureConfig` from ``ray_tpu/train/trainer.py``, which the Tuner
takes.

The trainer itself (``JaxTrainer``'s counterpart, with `ScalingConfig`
and `Result`) waits for the worker group, which needs the cluster
runtime (ROADMAP.md, queue 1): the JAX trainer gang-places its workers
through a placement group on the head, which local mode has not.
"""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.train.checkpoint import CheckpointConfig


@dataclasses.dataclass
class FailureConfig:
    """Reference: ray.train.FailureConfig — max_failures gang restarts."""

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    """Reference: ray.train.RunConfig (air/config.py)."""

    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig | None = None
    checkpoint_config: CheckpointConfig | None = None
    # Tune stop criteria: {"metric": threshold} — a trial terminates when
    # any named metric reaches its threshold (reference: air/config.py
    # RunConfig.stop)
    stop: dict | None = None
