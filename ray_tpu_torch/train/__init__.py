"""ray_tpu_torch.train — training on one NVIDIA card or on a mesh of
``torch.distributed`` ranks, the port of ``ray_tpu.train``'s SPMD step.

- `make_train_step` / `TrainState` (`spmd.py`): loss, gradient (flash
  attention's backward through kernels K2 and K3), global grad norm,
  optional gradient accumulation, optimizer update in place; on a mesh
  (``mesh=``, ``rules=``) with the ZeRO ladder (``zero_stage`` 0-3);
- `init_sharded_state`, `state_shardings`, `zero_shardings`,
  `zero1_shardings`, `batch_shardings`, `optimizer_state_bytes`: the
  mesh's layouts and what each rank holds;
- `adam` / `adamw` / `sgd`, `clip_by_global_norm`, `chain` and
  `global_norm` (`optim.py`): optax's optimizers with its defaults;
- `StepWaterfall`, `enable_step_waterfall`, `data_wait`: per-step time
  attribution.

The worker group and the trainer are later slices (ROADMAP.md).
"""

from ray_tpu_torch.train.optim import (
    EmptyState,
    GradientTransformation,
    ScaleByAdamState,
    TraceState,
    adam,
    adamw,
    chain,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from ray_tpu_torch.train.spmd import (
    StepWaterfall,
    TrainState,
    batch_shardings,
    data_wait,
    enable_step_waterfall,
    init_sharded_state,
    make_train_step,
    optimizer_state_bytes,
    state_shardings,
    waterfall,
    zero1_shardings,
    zero_shardings,
)

__all__ = [
    "EmptyState",
    "GradientTransformation",
    "ScaleByAdamState",
    "StepWaterfall",
    "TraceState",
    "TrainState",
    "adam",
    "adamw",
    "batch_shardings",
    "chain",
    "clip_by_global_norm",
    "data_wait",
    "enable_step_waterfall",
    "global_norm",
    "init_sharded_state",
    "make_train_step",
    "optimizer_state_bytes",
    "sgd",
    "state_shardings",
    "waterfall",
    "zero1_shardings",
    "zero_shardings",
]
