"""Collectives over one mesh axis, for code that runs on local shards.

The port of ``ray_tpu/parallel/ops.py``. In the JAX package these run
inside a ``shard_map`` body and XLA lowers them to ICI collectives;
here each one runs on this rank's local tensor over the process group
of one mesh axis (``mesh.get_group(axis)``), through PyTorch's
functional collectives, on the ambient mesh of `sharding.use_mesh`
(which `shard_map` sets for its body) unless ``mesh=`` names one.

`psum`, `pmean`, `all_gather`, `reduce_scatter`, `all_to_all` and
`ppermute` are differentiable, with JAX's transposes: the gradient of a
psum is a psum, of an all-gather a reduce-scatter and back, of an
all-to-all the all-to-all with split and concat swapped, and of a
permutation the inverse permutation. `pmax` is not (JAX defines no
transpose for it either). `axis_index` and `axis_size` are host ints.

`shard_map` is the port of ``jax.shard_map`` on top of DTensor's
``local_map``: specs become placements, the body sees local shards.
`collective_op_counts` counts the collectives one run issued, under the
JAX labels, from ``CommDebugMode``: there is no compiled program to
parse as the JAX version parses HLO.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.mesh import AXIS_DATA
from ray_tpu_torch.parallel.sharding import (
    PartitionSpec,
    _current_mesh,
    placements,
    use_mesh,
)


def _group(axis_name: str, mesh):
    """The process group of one mesh axis; None for an axis the mesh
    dropped because its size is 1 (``mesh.py``), over which every
    collective is the identity."""
    mesh = _current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError(f"no mesh for axis {axis_name!r}: run under "
                           "use_mesh(mesh) or shard_map, or pass mesh=")
    if axis_name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(axis_name)


def _wait(t):
    return funcol.wait_tensor(t) if isinstance(t, torch.Tensor) else t


def _sum(x, group):
    return _wait(funcol.all_reduce(x, "sum", group))


def _gather(x, axis: int, group):
    return _wait(funcol.all_gather_tensor(x.contiguous(), axis, group))


def _scatter(x, axis: int, group):
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", axis,
                                              group))


def _a2a(x, split_axis: int, concat_axis: int, group):
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=split_axis))  # (n, ...)
    out = _wait(funcol.all_to_all_single(parts.contiguous(), None, None,
                                         group))
    return torch.cat(out.unbind(0), dim=concat_axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axis, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _scatter(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _a2a(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _a2a(g, concat_axis, split_axis, ctx.group), None, None, None


def _permute(x, pairs, group):
    """Send x along (src, dst) axis-index pairs; a rank no pair sends
    to gets zeros."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _permute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.pairs)
        return _permute(g, inverse, ctx.group), None, None


def psum(x, axis_name: str = AXIS_DATA, *, mesh=None):
    group = _group(axis_name, mesh)
    return x if group is None else _Psum.apply(x, group)


def pmean(x, axis_name: str = AXIS_DATA, *, mesh=None):
    return psum(x, axis_name, mesh=mesh) / axis_size(axis_name, mesh=mesh)


def pmax(x, axis_name: str = AXIS_DATA, *, mesh=None):
    group = _group(axis_name, mesh)
    x = x.detach()
    return x if group is None else _wait(funcol.all_reduce(x, "max",
                                                           group))


def all_gather(x, axis_name: str, *, axis: int = 0, tiled: bool = True,
               mesh=None):
    """The axis's shards of x joined along `axis` (tiled) or stacked on
    a new dim `axis` (not tiled), as ``jax.lax.all_gather``."""
    group = _group(axis_name, mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    return x if group is None else _AllGather.apply(x, axis, group)


def reduce_scatter(x, axis_name: str, *, scatter_dimension: int = 0,
                   mesh=None):
    """``jax.lax.psum_scatter(..., tiled=True)``: the sum over the axis,
    this rank's block of it along `scatter_dimension`."""
    group = _group(axis_name, mesh)
    return x if group is None else _ReduceScatter.apply(
        x, scatter_dimension, group)


def all_to_all(x, axis_name: str, *, split_axis: int, concat_axis: int,
               mesh=None):
    group = _group(axis_name, mesh)
    return x if group is None else _AllToAll.apply(
        x, split_axis, concat_axis, group)


def ppermute(x, axis_name: str, perm, *, mesh=None):
    """x sent along `perm`'s (source, destination) axis indices; an index
    no pair sends to gets zeros, as ``jax.lax.ppermute``."""
    pairs = tuple((int(s), int(d)) for s, d in perm)
    group = _group(axis_name, mesh)
    if group is None:
        return x if (0, 0) in pairs else torch.zeros_like(x)
    return _Ppermute.apply(x, pairs, group)


def ring_shift(x, axis_name: str, shift: int = 1, *, mesh=None):
    """Shift values around the axis ring (building block of ring
    attention / pipelined collectives)."""
    n = axis_size(axis_name, mesh=mesh)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return ppermute(x, axis_name, perm, mesh=mesh)


def axis_index(axis_name: str, *, mesh=None) -> int:
    group = _group(axis_name, mesh)
    return 0 if group is None else dist.get_rank(group)


def axis_size(axis_name: str, *, mesh=None) -> int:
    group = _group(axis_name, mesh)
    return 1 if group is None else dist.get_world_size(group)


_LABELS = (("all_reduce", "allreduce"), ("allreduce", "allreduce"),
           ("all_gather", "all_gather"), ("allgather", "all_gather"),
           ("reduce_scatter", "reduce_scatter"),
           ("all_to_all", "all_to_all"), ("alltoall", "all_to_all"))


def collective_op_counts(comm) -> dict[str, int]:
    """The collectives of a run, keyed by the catalog's ``op=`` label
    names (allreduce/all_gather/reduce_scatter/all_to_all), from a
    ``torch.distributed.tensor.debug.CommDebugMode`` the run was made
    under (or its ``get_comm_counts()``). The JAX version parses the
    compiled step's HLO; here there is no compiled program, so this is
    what the run issued, DTensor's redistributions and the explicit
    collectives of this module alike. Point-to-point sends (`ppermute`,
    JAX's collective_permute) are not seen by CommDebugMode; any other
    collective keeps its own name."""
    counts = comm.get_comm_counts() if hasattr(comm, "get_comm_counts") \
        else comm
    out: dict[str, int] = {}
    for op, n in counts.items():
        name = str(op).split(".")[-1] if "." in str(op) else str(op)
        label = next((lab for key, lab in _LABELS if key in name), name)
        if n:
            out[label] = out.get(label, 0) + int(n)
    return out


def _spec_tuple(specs, n: int):
    if isinstance(specs, PartitionSpec) or specs is None:
        return (specs,) * n
    return tuple(specs)


def shard_map(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map`` on DTensor: f runs on each rank's local shards,
    with `mesh` ambient (so the collectives above find their groups).
    `in_specs` is one `PartitionSpec` per positional argument (or one for
    all); an argument that is a DTensor is redistributed to its spec, a
    plain tensor is taken as the global value, the same on every rank,
    and sharded by it. `out_specs` is one spec, or one per output; an
    output spec says how the local results tile the global value (a
    replicated axis takes the local value as the whole). Nothing checks
    that a replicated output really is the same on every rank (JAX's
    ``check_vma``, which the JAX wrapper turns off by default)."""

    def body(*args):
        with use_mesh(mesh):
            return f(*args)

    def call(*args):
        ins = _spec_tuple(in_specs, len(args))
        in_pl = tuple(None if s is None else placements(s, mesh)
                      for s in ins)
        args = tuple(
            distribute_tensor(a, mesh, pl)
            if pl is not None and isinstance(a, torch.Tensor)
            and not isinstance(a, DTensor) else a
            for a, pl in zip(args, in_pl))
        # local_map reads a tuple as one placement list per output
        if isinstance(out_specs, PartitionSpec):
            out_pl: Any = list(placements(out_specs, mesh))
        else:
            out_pl = tuple(list(placements(s, mesh)) for s in out_specs)
        return local_map(body, out_pl, in_placements=in_pl,
                         device_mesh=mesh, redistribute_inputs=True)(*args)

    return call
