"""ray_tpu_torch.train — training on one NVIDIA card, the port of the
single-device part of ``ray_tpu.train``.

- `make_train_step` / `TrainState` (`spmd.py`): loss, gradient (flash
  attention's backward through kernels K2 and K3), global grad norm,
  optional gradient accumulation, optimizer update in place;
- `adamw` / `sgd` (`optim.py`): optax's optimizers with its defaults;
- `StepWaterfall`, `enable_step_waterfall`, `data_wait`: per-step time
  attribution.

Meshes, the ZeRO ladder, the worker group and the trainer are later
slices (ROADMAP.md).
"""

from ray_tpu_torch.train.optim import (
    GradientTransformation,
    ScaleByAdamState,
    TraceState,
    adamw,
    sgd,
)
from ray_tpu_torch.train.spmd import (
    StepWaterfall,
    TrainState,
    data_wait,
    enable_step_waterfall,
    make_train_step,
    waterfall,
)

__all__ = [
    "GradientTransformation",
    "ScaleByAdamState",
    "StepWaterfall",
    "TraceState",
    "TrainState",
    "adamw",
    "data_wait",
    "enable_step_waterfall",
    "make_train_step",
    "sgd",
    "waterfall",
]
