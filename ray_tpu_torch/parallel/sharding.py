"""Partition-rule based sharding for parameter trees, on DTensor.

The port of ``ray_tpu/parallel/sharding.py``. A model ships an ordered
list of (path regex -> `PartitionSpec`) rules; they are mapped over the
parameter tree to layouts, and the framework inserts the collectives:
GSPMD in the JAX package, DTensor's sharding propagation here. The
`NamedSharding` of this module pairs a mesh with a spec, as
``jax.sharding.NamedSharding`` does, and `placements` turns a spec into
the DTensor placements that realise it.

`PartitionSpec` is the port's own (a tuple, as JAX's is), since
``jax.sharding`` may not be imported here. One entry per tensor dim:
None (replicated), an axis name, or a tuple of axis names.

Deviation: a dim sharded over several axes is split over them in the
mesh's dim order (DTensor's ``Shard`` placements nest outermost mesh dim
first), where JAX splits it in the order the spec lists them. The two
agree wherever the spec lists its axes in mesh order, as the batch's
``("data", "fsdp")`` does; `add_axis_to_spec` can write
``("tensor", "data")``, where the set of shards is the same but a
different rank owns each one. Full-tensor values are unaffected.
"""

from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Any, Sequence

from torch.distributed.tensor import (
    DTensor,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.util import tree as tree_util

PyTree = Any


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``PartitionSpec(None, "tensor")``
    leaves dim 0 replicated and shards dim 1 over the tensor axis; a
    dim may name a tuple of axes. Missing trailing entries are None. As
    in JAX, a one-axis tuple is stored as the axis itself."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


class NamedSharding:
    """A mesh and a spec: the counterpart of
    ``jax.sharding.NamedSharding``. ``placements`` gives the DTensor
    placements on a DeviceMesh (or the names of an `AbstractMesh`)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple[Placement, ...]:
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


class PartitionRules:
    """Ordered (regex, PartitionSpec) rules; first match wins.

    Specs may name axes that a given mesh doesn't have — those axis names
    are dropped at resolution time, so one rule set serves every mesh
    shape (a tensor='absent' mesh simply replicates that dimension).
    """

    def __init__(self, rules: Sequence[tuple[str, PartitionSpec]]):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str, mesh=None) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(path):
                return _prune_spec(spec, mesh) if mesh is not None else spec
        return PartitionSpec()

    def shardings(self, tree: PyTree, mesh) -> PyTree:
        return tree_util.tree_map_with_path(
            lambda path, _: NamedSharding(
                mesh, self.spec_for(path_str(path), mesh)), tree)

    def specs(self, tree: PyTree, mesh=None) -> PyTree:
        return tree_util.tree_map_with_path(
            lambda path, _: self.spec_for(path_str(path), mesh), tree)


def _prune_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop axis names not present in (or of size 1 in) the mesh."""
    have = {n for n, s in mesh_shape(mesh).items() if s > 1}

    def prune(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in have)
            return kept if kept else None
        return entry if entry in have else None

    return PartitionSpec(*(prune(e) for e in spec))


def add_axis_to_spec(spec: PartitionSpec, shape, mesh, axis: str
                     ) -> PartitionSpec:
    """Extend `spec` (already pruned to `mesh`) with `axis` on the first
    dimension of `shape` that divides evenly by the combined shard count
    — the ZeRO-style "also shard this leaf over the replica axis"
    transformation. Leaves already touching `axis`, scalars, and leaves
    with no evenly-divisible dimension come back unchanged (those stay
    replicated over `axis` and are counted by the caller's ~1/N memory
    assertion slack)."""
    sizes = mesh_shape(mesh)
    n = sizes.get(axis, 1)
    if n <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def axes_of(entry):
        if entry is None:
            return ()
        if isinstance(entry, (tuple, list)):
            return tuple(entry)
        return (entry,)

    if any(axis in axes_of(e) for e in entries):
        return spec
    for i, dim in enumerate(shape):
        cur = axes_of(entries[i])
        already = math.prod(sizes.get(a, 1) for a in cur)
        if dim % (already * n) == 0:
            entries[i] = cur + (axis,) if cur else axis
            return PartitionSpec(*entries)
    return spec


def placements(spec: PartitionSpec, mesh) -> tuple[Placement, ...]:
    """The DTensor placements of a spec already pruned to `mesh`: one
    per mesh dim, ``Shard(d)`` where the spec names that axis on tensor
    dim d and ``Replicate()`` elsewhere. A dim named by several axes is
    split over them in mesh-dim order (see the module's deviation)."""
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                if a in dim_of:
                    raise ValueError(f"axis {a!r} names two dims of {spec}")
                dim_of[a] = d
    names = tuple(mesh_shape(mesh))
    unknown = set(dim_of) - set(names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} that the "
                         f"mesh {names} lacks; prune it first")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


def shard_pytree(tree: PyTree, rules: PartitionRules, mesh) -> PyTree:
    """Every leaf of `tree` as a DTensor laid out by `rules` on `mesh`.
    Each rank passes the full tree; rank 0's values are the ones
    scattered (``distribute_tensor``), so the ranks need not agree."""
    return tree_util.tree_map_with_path(
        lambda path, leaf: distribute_tensor(
            leaf, mesh, placements(rules.spec_for(path_str(path), mesh),
                                   mesh)), tree)


_ambient = threading.local()


def _current_mesh():
    """The ambient mesh, if code runs under `use_mesh` (a `shard_map`
    body); None otherwise."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the ambient mesh of this thread for the block: the
    port's ``with mesh:``, which the collectives of ``parallel/ops.py``
    read (`shard_map` enters it around its body)."""
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def constrain(x, *spec_entries):
    """Lay a DTensor out as the spec says on its own mesh (a
    redistribute, differentiable), tolerating axes the mesh lacks, so
    model code can always write the full logical spec. A plain tensor
    comes back as it is. The mesh is the tensor's, never a thread's
    ambient one: a remat block replayed in the backward, which runs on
    the autograd engine's own thread for CUDA tensors, lays its
    activations out as the first forward did."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(_prune_spec(PartitionSpec(*spec_entries), mesh),
                      mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def batch_spec(ndim: int, last=None) -> tuple:
    """The spec entries of an activation of `ndim` dims whose dim 0 is
    the batch (over ("data", "fsdp")) and whose last dim goes over
    `last`, the dims between replicated: the JAX models write (batch,
    None, last) for a (B, T, E) activation and (batch, last) for a
    decode step's (B, E), where the port's blocks share one body for
    both. Use as ``constrain(x, *batch_spec(x.ndim, last))``."""
    return (("data", "fsdp"), *([None] * (ndim - 2)), last)


def unflatten_heads(x, heads: int, head_dim: int):
    """x (..., heads * head_dim) -> (..., heads, head_dim). A DTensor
    sharded on its last dim over a mesh dim whose size does not divide
    `heads` is made whole over that dim first: DTensor refuses the
    uneven split (Llama's K/V projection with fewer KV heads than
    tensor ranks), where GSPMD inserts the same gather itself."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = [Replicate() if isinstance(p, Shard)
              and p.dim % x.ndim == x.ndim - 1 and heads % mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], heads, head_dim)


def replicate_like(x, like):
    """`x`, a plain tensor made the same way on every rank (positions,
    masks, rotary angles), lifted onto `like`'s mesh as a replicated
    DTensor when `like` is one; otherwise `x` as it is. DTensor refuses
    to mix the two kinds in one operator."""
    if not isinstance(like, DTensor) or isinstance(x, DTensor):
        return x
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
