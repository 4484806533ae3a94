"""The parallelism layer on ``torch.distributed``: the port of
``ray_tpu.parallel``.

Device meshes over the ranks of a process group (`mesh.py`, a
``DeviceMesh`` with the JAX mesh's axis names and order),
partition-rule based sharding of parameter trees as DTensors
(`sharding.py`), and collectives over one mesh axis for code on local
shards, with ``shard_map`` (`ops.py`); ring and Ulysses attention over a
sequence axis (`ring_attention.py`); and pipeline parallelism
(`pipeline.py`): the 1F1B schedule math of the worker-group strategy and
the in-program GPipe and interleaved schedules over the ``pipe`` axis.
"""

from ray_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    MeshSpec,
    build_mesh,
    local_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    PartitionRules,
    shard_pytree,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_TENSOR",
    "AXIS_SEQ",
    "AXIS_EXPERT",
    "AXIS_PIPE",
    "MeshSpec",
    "build_mesh",
    "local_mesh",
    "PartitionRules",
    "shard_pytree",
]
