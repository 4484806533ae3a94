"""Device meshes over the ranks of a ``torch.distributed`` process group.

The port of ``ray_tpu/parallel/mesh.py``. The JAX module builds a
``jax.sharding.Mesh`` over the chips of a slice; here the unit is one
process per card (one rank), and `build_mesh` lays the ranks of the
initialised process group out as a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the same
axis names (data / fsdp / tensor / seq / expert / pipe / dcn), in the
same canonical order: the outermost axis is the one that may cross
hosts, the innermost the one that needs the most bandwidth.

Deviation: the JAX mesh keeps its axes of size 1; the DeviceMesh drops
them (`MeshSpec.resolve` still names all seven), because DTensor works
out an operator's layout by enumerating strategies over every mesh dim,
which grows exponentially with their number: seven dims made one
embedding lookup run for minutes. Partition specs are pruned to the
axes of size > 1 anyway, so one spec still serves every mesh; a
collective over an absent axis (``parallel/ops.py``) is the identity.
A world of one rank keeps one dim, the first of data or the first axis
named.

No process group is made here: the caller initialises
``torch.distributed`` (its address, world size and rank), and
`build_mesh` raises when it has not, so nothing quietly builds a
one-rank world.

The JAX module also turns on ``jax_threefry_partitionable`` so that a
sharded ``jax.random`` draw gives the bits of the unsharded one. That
flag has no counterpart: the port draws its initial parameters whole
on every rank from one seeded ``torch.Generator`` and then shards them
(``train/spmd.py`` `init_sharded_state`).
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Canonical axis names. Order matters: the slowest-varying axis should be
# the one crossing hosts (dcn/data), the fastest-varying ones
# (tensor/seq) need the highest bandwidth and stay within a host.
AXIS_DCN = "dcn"  # across hosts (data-parallel only; low bandwidth)
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"

# Canonical order from outermost to innermost.
CANONICAL_AXIS_ORDER = (
    AXIS_DCN,
    AXIS_DATA,
    AXIS_PIPE,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_TENSOR,
)

# Batch-like activation dimensions are sharded over every replica-ish axis.
BATCH_AXES = (AXIS_DCN, AXIS_DATA, AXIS_FSDP)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. Size -1 on at most one axis means "infer
    from the rank count". Axes of size 1 are kept (they make partition
    specs uniform across configurations)."""

    data: int = -1
    pipe: int = 1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    dcn: int = 1  # number of hosts (outermost, data-parallel only)

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {
            AXIS_DCN: self.dcn,
            AXIS_DATA: self.data,
            AXIS_PIPE: self.pipe,
            AXIS_FSDP: self.fsdp,
            AXIS_EXPERT: self.expert,
            AXIS_SEQ: self.seq,
            AXIS_TENSOR: self.tensor,
        }
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one axis may be -1, got {unknown}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}"
                )
            sizes[unknown[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {known} devices, have {n_devices}"
            )
        return sizes


class AbstractMesh:
    """Axis names and sizes without ranks or process groups: the
    counterpart of ``jax.sharding.AbstractMesh``. The sharding
    arithmetic (`sharding._prune_spec`, `add_axis_to_spec`,
    `placements`, the ZeRO layouts of ``train/spmd.py``) reads only
    these, so it runs on one without a process group."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's dim order, of a DeviceMesh, an
    `AbstractMesh` or a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def build_mesh(spec: MeshSpec | Mapping[str, int] | None = None,
               device: str | None = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the initialised process group,
    dims named and in canonical axis order (axes the caller names that
    are not canonical go last; axes of size 1 left out, see the module's
    deviation); rank r sits at the row-major position r.
    The device type is "cuda" unless the caller passes device="cpu"."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh: torch.distributed is not initialised; call "
            "torch.distributed.init_process_group (address, world size "
            "and rank) first")
    n = dist.get_world_size()
    if spec is None:
        spec = MeshSpec()
    sizes = (spec.resolve(n) if isinstance(spec, MeshSpec)
             else dict(spec))
    names = tuple(a for a in CANONICAL_AXIS_ORDER if a in sizes)
    names += tuple(a for a in sizes if a not in names)
    shape = tuple(sizes[a] for a in names)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    kept = tuple(a for a in names if sizes[a] > 1) or \
        ((AXIS_DATA,) if AXIS_DATA in names else names[:1])
    dev = "cuda" if device is None else torch.device(device).type
    ranks = torch.arange(n, dtype=torch.int64).reshape(
        tuple(sizes[a] for a in kept))
    return DeviceMesh(dev, ranks, mesh_dim_names=kept)


def local_mesh(**axes: int) -> DeviceMesh:
    """Convenience: mesh over all ranks, e.g. local_mesh(data=-1); a
    ``device`` keyword picks the device type as in `build_mesh`."""
    device = axes.pop("device", None)
    if not axes:
        axes = {AXIS_DATA: -1}
    return build_mesh(MeshSpec(**axes), device=device)


def slice_groups() -> dict[int, list[int]]:
    """Group the ranks of the process group by host, the GPU's
    counterpart of a TPU slice (the DCN domain): {host index: [ranks]},
    hosts numbered in the order of their lowest rank. A collective over
    the world (every rank must call it); without a process group, the
    one process is rank 0 of host 0."""
    if not dist.is_available() or not dist.is_initialized():
        return {0: [0]}
    hosts: list = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    order = list(dict.fromkeys(hosts))
    groups: dict[int, list[int]] = {}
    for rank, host in enumerate(hosts):
        groups.setdefault(order.index(host), []).append(rank)
    return groups
