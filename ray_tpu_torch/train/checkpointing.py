"""Saving and restoring trees of tensors (a `TrainState` above all) to a
checkpoint directory: the port of ``ray_tpu/train/checkpointing.py``, in
its directory format.

- ``state.npz`` holds one array ``leaf_i`` per leaf, in the JAX leaf
  order: a dict's leaves by sorted key, a list's or tuple's by index, a
  dataclass's by field (optax's named-tuple states flatten by field the
  same way, so adam's state is ``count, mu..., nu...`` on both sides).
  None and a dataclass with no fields (`EmptyState`) hold no leaf; host
  ints and floats (``TrainState.step``, adam's ``count``) are 0-d
  arrays. A bf16 tensor is stored as its int16 bits (numpy has no
  bfloat16).
- ``treedef.pkl`` holds ``{"format", "n_leaves", "treedef"}``. The
  port's treedef is a nested tuple of strings: the structure, each
  dataclass by module and name, each tensor's dtype. It is read with an
  unpickler that loads no class, so reading it imports nothing.

`save_pytree` gathers each DTensor whole (``full_tensor``, a collective:
every rank calls it), rank 0 writes, and the ranks meet at a barrier.
`load_pytree` with a template puts each leaf where the template's leaf
is: a DTensor is laid out with the template's mesh and placements (each
rank reads the file and keeps its own shard), a tensor goes to the
template's device and dtype, a host int stays a host int. Without a
template it rebuilds the saved structure on ``device`` (the card unless
the caller names another).

A checkpoint the JAX package wrote has a pickled jax treedef, which
the port cannot read; it is loaded by leaf order against a template
(`load_train_state` always has one). Its step and adam count are 0-d
int32 arrays, which become host ints.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import os
import pickle
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.util.device import resolve_device

_STATE_FILE = "state.npz"
_TREE_FILE = "treedef.pkl"
_FORMAT = 1


def _flatten(tree: Any) -> tuple[tuple, list]:
    """(treedef, leaves) of `tree`, leaves in the JAX order."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(walk(t[k]) for k in keys))
        if type(t) in (list, tuple):
            return (type(t).__name__, tuple(walk(v) for v in t))
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            names = tuple(f.name for f in dataclasses.fields(t))
            cls = type(t)
            return ("dataclass", f"{cls.__module__}:{cls.__qualname__}",
                    names, tuple(walk(getattr(t, n)) for n in names))
        if t is None:
            return ("none",)
        leaves.append(t)
        if isinstance(t, torch.Tensor):
            return ("tensor", str(t.dtype).removeprefix("torch."))
        for kind in (bool, int, float):
            if isinstance(t, kind):
                return (kind.__name__,)
        if isinstance(t, np.ndarray):
            return ("ndarray",)
        raise TypeError(f"cannot checkpoint a leaf of type {type(t)}")

    return walk(tree), leaves


def _unflatten(treedef: tuple, leaves) -> Any:
    """The tree `treedef` describes, with `leaves` in the JAX order."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind in ("list", "tuple"):
            return (list if kind == "list" else tuple)(build(c)
                                                      for c in d[1])
        if kind == "dataclass":
            module, _, qualname = d[1].partition(":")
            cls = importlib.import_module(module)
            for part in qualname.split("."):
                cls = getattr(cls, part)
            return cls(**{n: build(c) for n, c in zip(d[2], d[3])})
        if kind == "none":
            return None
        return next(it)

    return build(treedef)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float64)
    return np.asarray(leaf)


def _rank_and_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_pytree(tree, directory: str, *, process_index: int | None = None):
    """Collectively save a tree of (possibly DTensor) tensors.

    In a ``torch.distributed`` world every rank MUST call this (gathering
    a DTensor is collective). Only rank 0 (or `process_index` 0)
    writes."""
    treedef, leaves = _flatten(tree)
    rank, world = _rank_and_world()
    pid = rank if process_index is None else process_index
    host_leaves = [_to_host(leaf) for leaf in leaves]
    if pid == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, _STATE_FILE + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **{f"leaf_{i}": a
                           for i, a in enumerate(host_leaves)})
        os.replace(tmp, os.path.join(directory, _STATE_FILE))
        with open(os.path.join(directory, _TREE_FILE), "wb") as f:
            pickle.dump({"format": _FORMAT, "treedef": treedef,
                         "n_leaves": len(host_leaves)}, f)
    if world > 1:
        import torch.distributed as dist

        dist.barrier()


class _NoClasses(pickle.Unpickler):
    """Reads plain containers and strings only: a pickle that names a
    class (the JAX package's treedef) raises instead of importing it."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name}")


def _read_meta(directory: str) -> dict | None:
    """The port's metadata, or None for a checkpoint the JAX package
    wrote (its treedef names jax classes)."""
    with open(os.path.join(directory, _TREE_FILE), "rb") as f:
        blob = f.read()
    try:
        return _NoClasses(io.BytesIO(blob)).load()
    except pickle.UnpicklingError:
        return None


def _leaf_like(arr: np.ndarray, saved: tuple | None, like):
    """A saved array placed where the template's leaf `like` is."""
    if isinstance(like, (torch.Tensor, np.ndarray)) and \
            tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape} against a "
                         f"template leaf of shape {tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        t = _tensor(arr, saved)
        if isinstance(like, DTensor):
            return distribute_tensor(
                t.to(like.device, like.dtype), like.device_mesh,
                like.placements, src_data_rank=None)
        return t.to(like.device, like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def _tensor(arr: np.ndarray, saved: tuple | None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if saved is not None and saved[1:] == ("bfloat16",):
        t = t.view(torch.bfloat16)
    return t


def _leaf_specs(treedef: tuple) -> list[tuple]:
    """The leaf entries of a treedef, in leaf order."""
    kind = treedef[0]
    kids = {"dict": 2, "list": 1, "tuple": 1, "dataclass": 3}.get(kind)
    if kids is None:
        return [] if kind == "none" else [treedef]
    return [s for c in treedef[kids] for s in _leaf_specs(c)]


def load_pytree(directory: str, template=None, *, device=None):
    """Load a tree saved by `save_pytree` (or by the JAX package's).

    With `template` (a tree of the saved structure) each leaf goes where
    the template's leaf is; see the module docstring. Without one the
    saved structure is rebuilt with its tensors on `device`, the card
    unless the caller names another."""
    meta = _read_meta(directory)
    with np.load(os.path.join(directory, _STATE_FILE)) as data:
        n = meta["n_leaves"] if meta is not None else sum(
            1 for k in data.files if k.startswith("leaf_"))
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    saved = (_leaf_specs(meta["treedef"]) if meta is not None
             else [None] * n)
    if template is None:
        if meta is None:
            raise ValueError(
                f"{directory} was written by the JAX package: its "
                "treedef is a pickled jax treedef, which the port cannot "
                "read; pass a template to load it by leaf order")
        dev = resolve_device(device)
        return _unflatten(meta["treedef"], [
            _tensor(a, s).to(dev) if s[0] == "tensor"
            else a if s[0] == "ndarray" else
            {"bool": bool, "int": int, "float": float}[s[0]](a.item())
            for a, s in zip(arrays, saved)])
    treedef, likes = _flatten(template)
    if len(likes) != n:
        raise ValueError(f"{directory} holds {n} leaves; the template "
                         f"has {len(likes)}")
    return _unflatten(treedef, [_leaf_like(a, s, like)
                                for a, s, like in zip(arrays, saved, likes)])


def save_train_state(state, directory: str):
    """Save a `TrainState`'s params, optimizer state and step (the
    gradient-accumulation buffer is not saved, as in the JAX package)."""
    save_pytree({"params": state.params, "opt_state": state.opt_state,
                 "step": state.step}, directory)


def load_train_state(directory: str, state_template):
    """Restore into the layout of `state_template` (a `TrainState` whose
    tensors sit on the target devices, or are DTensors with the target
    placements); the checkpoint may come from the port or from the JAX
    package's `save_train_state`."""
    loaded = load_pytree(directory, {
        "params": state_template.params,
        "opt_state": state_template.opt_state,
        "step": state_template.step})
    return type(state_template)(
        params=loaded["params"], opt_state=loaded["opt_state"],
        step=loaded["step"])
