"""Parameter trees: nested dicts, lists and tuples whose leaves are
tensors.

The port's stand-in for the parts of ``jax.tree_util`` the train path
uses, and for ``jax.lax.scan`` over a model's stacked layers. As in
``jax.tree_util``, a dict's leaves are visited in sorted-key order and
a list's or tuple's in index order, so two trees of the same structure
flatten to matching lists (the RL models are lists of ``{"w", "b"}``
layers). Only plain lists and tuples are walked: a subclass of tuple
(`parallel.sharding.PartitionSpec`, a named tuple) is a leaf, as it is
to ``jax.tree_util``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _seq(tree: Any) -> bool:
    return type(tree) in (list, tuple)


def leaves(tree: Any) -> list:
    """The leaves of `tree`: a dict's in sorted-key order, a list's or
    tuple's in index order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if _seq(tree):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaves_with_path(tree: Any, path: tuple = ()) -> list:
    """``(path, leaf)`` pairs in `leaves`' order; a path is the tuple of
    keys (a list's or tuple's index as a string) from the root."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], path + (k,))]
    if _seq(tree):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_path(v, path + (str(i),))]
    return [(path, tree)]


def unflatten(like: Any, flat) -> Any:
    """A tree shaped like `like` whose leaves are `flat`, in the order
    `leaves(like)` gives."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _seq(t):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` applied to every leaf of `tree`, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _seq(tree):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` applied to every leaf of `tree`, same keys; a
    path is the tuple of keys from the root (joined with "/" by
    ``parallel.sharding.path_str``). Besides dicts it walks the
    optimizers' state dataclasses, whose field names join the path (so
    ``mu/blocks/attn_qkv/kernel`` ends with its param's path), and
    lists and tuples (the tuple of states of ``optim.chain``, the RL
    models' lists of layers), whose indices join it; host scalars
    (the step counts) and None stay as they are."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _seq(tree):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       path + (f.name,))
            for f in dataclasses.fields(tree)})
    if tree is None or isinstance(tree, (int, float)):
        return tree
    return fn(path, tree)


def unstack(tree: Any) -> list:
    """The trees of a tree of stacked ``[L, ...]`` leaves, one per index
    of the leading axis, with one ``unbind(0)`` per leaf: its backward
    stacks the L grads once, where indexing ``t[i]`` per layer would add
    a zero tensor the size of the whole stack for each layer."""
    per = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [u[i] for u in per])
            for i in range(len(per[0]))]


def scan_layers(blocks: Any, x, step: Callable):
    """x through every layer of the stacked tree `blocks`:
    ``step(i, p, x) -> (x, (k, v))`` runs layer i with its params p.
    Returns (x, k, v) with each layer's k and v stacked (L, ...)."""
    import torch

    ks, vs = [], []
    for i, p in enumerate(unstack(blocks)):
        x, (k, v) = step(i, p, x)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)
