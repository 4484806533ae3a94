"""Parameter trees: nested dicts whose leaves are tensors.

The port's stand-in for the parts of ``jax.tree_util`` the train path
uses, and for ``jax.lax.scan`` over a model's stacked layers. Leaves
are visited in sorted-key order, so two trees with the same keys
flatten to matching lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves of `tree`, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like: Any, flat) -> Any:
    """A tree shaped like `like` whose leaves are `flat`, in the order
    `leaves(like)` gives."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` applied to every leaf of `tree`, same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` applied to every leaf of `tree`, same keys; a
    path is the tuple of keys from the root (joined with "/" by
    ``parallel.sharding.path_str``). Besides dicts it walks the
    optimizers' state dataclasses, whose field names join the path (so
    ``mu/blocks/attn_qkv/kernel`` ends with its param's path), and the
    tuple of states of ``optim.chain``, whose indices join it; host
    scalars (their step counts) and None stay as they are."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map_with_path(fn, v, path + (str(i),))
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
