"""Parameter trees: nested dicts whose leaves are tensors.

The port's stand-in for the parts of ``jax.tree_util`` the train path
uses. Leaves are visited in sorted-key order, so two trees with the same
keys flatten to matching lists.
"""

from __future__ import annotations

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
