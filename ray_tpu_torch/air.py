"""ray_tpu_torch.air — the shared AIR-style config/result surface.

Reference parity: ray.air (python/ray/air/config.py — ScalingConfig /
RunConfig / FailureConfig / CheckpointConfig shared by Train and Tune,
air/result.py Result, plus the session helpers). These types live with
the trainer implementation; this module is the stable shared namespace
the reference exposes them under, so `from ray_tpu_torch.air import
ScalingConfig` works for users arriving from the reference API.

The port's copy of ``ray_tpu/air.py``: its `ScalingConfig` takes
``use_gpu`` where JAX's takes ``use_tpu``, and its trainer is
`TorchTrainer` (``ray_tpu_torch.train``).
"""

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointConfig
from ray_tpu_torch.train.session import get_context
from ray_tpu_torch.train.trainer import (
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "get_context",
]
