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
  attribution;
- `Checkpoint`, `CheckpointConfig`, `CheckpointManager` (``checkpoint.py``):
  directory checkpoints with top-k retention; ``checkpointing.py``'s
  `save_train_state` / `load_train_state` write and read a train state
  (DTensors included) in the JAX package's directory format, and read
  the JAX package's checkpoints;
- `report`, `get_context`, `get_checkpoint`, `get_dataset_shard`
  (``session.py``): the train session a worker reports through and
  reads its shard of a dataset from;
- `TorchTrainer`, `ScalingConfig`, `RunConfig`, `FailureConfig`,
  `Result`, `TrainingFailedError` (``trainer.py``) and the worker group
  (``worker_group.py``): a gang of worker processes on the cluster
  runtime, joined by a ``torch.distributed`` process group, running a
  train loop with gang restart from the latest checkpoint and elastic
  sizing.
"""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointConfig,
    CheckpointManager,
)
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
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
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
from ray_tpu_torch.train.trainer import (
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainingFailedError,
)

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "EmptyState",
    "FailureConfig",
    "GradientTransformation",
    "Result",
    "RunConfig",
    "ScaleByAdamState",
    "ScalingConfig",
    "StepWaterfall",
    "TorchTrainer",
    "TraceState",
    "TrainState",
    "TrainingFailedError",
    "adam",
    "adamw",
    "batch_shardings",
    "chain",
    "clip_by_global_norm",
    "data_wait",
    "enable_step_waterfall",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "global_norm",
    "init_sharded_state",
    "make_train_step",
    "optimizer_state_bytes",
    "report",
    "sgd",
    "state_shardings",
    "waterfall",
    "zero1_shardings",
    "zero_shardings",
]
