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

`shard_map` is the port of ``jax.shard_map`` on DTensor: specs become
placements, the body sees local shards (``to_local``/``from_local``).
`collective_op_counts` counts the collectives one run issued, under the
JAX labels, from ``CommDebugMode``: there is no compiled program to
parse as the JAX version parses HLO.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ray_tpu_torch.parallel.mesh import AXIS_DATA, mesh_shape
from ray_tpu_torch.parallel.sharding import (
    PartitionSpec,
    _current_mesh,
    placements,
    use_mesh,
)


def _group(axis_name: str, mesh):
    """The process group of one mesh axis; None for an axis of size 1,
    over which every collective is the identity: one the mesh dropped
    (``mesh.py``), or the one dim a mesh of one rank keeps."""
    mesh = _current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError(f"no mesh for axis {axis_name!r}: run under "
                           "use_mesh(mesh) or shard_map, or pass mesh=")
    if not isinstance(mesh, DeviceMesh):
        # an AbstractMesh (a one-device mesh of named axes): only axes of
        # size 1, over which every collective is the identity
        if mesh_shape(mesh).get(axis_name, 1) != 1:
            raise RuntimeError(f"axis {axis_name!r} of {mesh!r} has no "
                               "ranks: build the mesh with build_mesh")
        return None
    if axis_name not in mesh.mesh_dim_names \
            or mesh.size(mesh.mesh_dim_names.index(axis_name)) == 1:
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


def _on_local(x, fn):
    """`fn` applied to x, or to the local tensor of a DTensor x with the
    result put back on x's mesh in x's placements (`psum` and `ppermute`,
    which keep shapes). A DTensor here lives on the mesh of the axes a
    `shard_map(axis_names=)` leaves automatic; the collective's own axis
    is manual, and its group joins ranks at the same position on those
    other axes, whose local tensors line up."""
    if not isinstance(x, DTensor):
        return fn(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh,
                              x.placements, run_check=False)


def psum(x, axis_name: str = AXIS_DATA, *, mesh=None):
    group = _group(axis_name, mesh)
    return x if group is None else _on_local(
        x, lambda t: _Psum.apply(t, group))


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
    return _on_local(x, lambda t: _Ppermute.apply(t, pairs, group))


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


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def shard_map(f: Callable, mesh, in_specs, out_specs,
              axis_names=None) -> Callable:
    """``jax.shard_map`` on DTensor: f runs on each rank's local shards,
    with `mesh` ambient (so the collectives above find their groups).
    `in_specs` is one `PartitionSpec` per positional argument (or one for
    all); an argument that is a DTensor is redistributed to its spec, a
    plain tensor is taken as the global value, the same on every rank,
    and sharded by it. `out_specs` is one spec, or one per output; an
    output spec says how the local results tile the global value (a
    replicated axis takes the local value as the whole). Nothing checks
    that a replicated output really is the same on every rank (JAX's
    ``check_vma``, which the JAX wrapper turns off by default).

    Gradients follow JAX's transpose of ``shard_map`` with ``check_vma``
    off: the gradient of an input replicated over a manual axis is the
    sum of every rank's share (the local gradient enters as a pending
    sum), and the gradient reaching an output replicated over manual
    axes is divided by their size, since every rank's copy of it carries
    the whole cotangent.

    `axis_names`, as in ``jax.shard_map``, makes only those mesh axes
    manual (default: all). The body then sees each argument local over
    the manual axes and global over the others: a DTensor on the
    sub-mesh of the other axes (``DTensor.from_local`` on
    ``mesh[other axes]``) that keeps the argument's placements there, so
    DTensor's propagation plays GSPMD's part for them; the specs name
    manual axes only. A tensor the body makes from nothing (a position,
    a mask) must be lifted onto that sub-mesh with
    ``sharding.replicate_like``, where JAX takes a constant as the same
    on every device: DTensor refuses to mix the two kinds, in the
    backward too."""
    names = tuple(mesh.mesh_dim_names)
    auto = () if axis_names is None else tuple(
        a for a in names if a not in set(axis_names))
    sub = mesh[auto] if auto else None
    manual = [i for i, a in enumerate(names) if a not in auto]
    keep = [i for i, a in enumerate(names) if a in auto]
    sizes = mesh_shape(mesh)

    def enter(a, spec):
        want = placements(spec, mesh)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * len(names),
                                   run_check=False)
        pl = tuple(want[i] if i in manual else a.placements[i]
                   for i in range(len(names)))
        for i in keep:
            if isinstance(pl[i], Shard) and any(
                    want[j] == pl[i] for j in manual):
                raise ValueError(
                    f"shard_map: dim {pl[i].dim} is sharded over a manual "
                    f"and an automatic axis at once ({pl})")
        a = a.redistribute(mesh, pl)
        grad_pl = [Partial() if i in manual and isinstance(p, Replicate)
                   else p for i, p in enumerate(pl)]
        local = a.to_local(grad_placements=grad_pl)
        if sub is None:
            return local
        return DTensor.from_local(local, sub, [pl[i] for i in keep],
                                  run_check=False)

    def leave(o, spec):
        want = placements(spec, mesh)
        if isinstance(o, DTensor):
            local, have = o.to_local(), o.placements
        else:
            local, have = o, (Replicate(),) * len(keep)
        n = math.prod(sizes[names[i]] for i in manual
                      if isinstance(want[i], Replicate))
        if n > 1:
            local = _ScaleGrad.apply(local, 1.0 / n)
        pl = list(want)
        for j, i in enumerate(keep):
            pl[i] = have[j]
        return DTensor.from_local(local, mesh, pl, run_check=False)

    def call(*args):
        ins = _spec_tuple(in_specs, len(args))
        args = tuple(enter(a, s) if s is not None else a
                     for a, s in zip(args, ins))
        with use_mesh(mesh):
            out = f(*args)
        if isinstance(out_specs, PartitionSpec):
            return leave(out, out_specs)
        return tuple(leave(o, s) for o, s in zip(out, out_specs))

    return call
