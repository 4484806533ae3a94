"""Optimizers with optax's names, defaults and arithmetic: `adam`,
`adamw` and `sgd`, the port's counterparts of ``optax.adam``,
``optax.adamw`` and ``optax.sgd``, and `clip_by_global_norm` and `chain`
to compose them (``optax.chain(optax.clip_by_global_norm(c),
optax.adam(lr))`` is the RL learners' optimizer).

Each is a `GradientTransformation` with optax's two functions, one
difference in the second:

- ``init(params) -> state``;
- ``update(grads, state, params) -> (params, state)``: it applies the
  update itself, writing the new values into the params' tensors in
  place (what ``optax.apply_updates`` with a donated state does), with
  ``torch._foreach_*`` kernels over all leaves at once. A transformation
  that only rescales the gradient (`clip_by_global_norm`, whose
  ``applies`` is False) writes the grads' tensors in place instead and
  leaves the params; in a `chain` it comes before the one that applies.

Trees are nested dicts, lists and tuples of tensors
(`ray_tpu_torch.util.tree`). The step count lives on the host as an
int, so the bias corrections are host floats and an update never waits
for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.util import tree


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    # True: `update` writes the step into the params; False: it rescales
    # the grads in place and leaves the params
    applies: bool = True


@dataclasses.dataclass
class EmptyState:
    """optax's EmptyState: a transformation that keeps no state."""


@dataclasses.dataclass
class ScaleByAdamState:
    """optax's ScaleByAdamState: steps taken, first and second moments."""
    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass
class TraceState:
    """optax's TraceState: the momentum buffer (None without momentum)."""
    trace: Any


def _zeros(params):
    return tree.tree_map(torch.zeros_like, params)


def global_norm(grads: list) -> torch.Tensor:
    """optax.global_norm: the 2-norm of the tensors `grads` taken
    together, a 0-d tensor left on the device. DTensors give the norm of
    the whole tensors, the same on every rank, not of this rank's
    shards."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: when the grads' `global_norm` g is at
    least `max_norm`, every grad is scaled by ``max_norm / g``; below it
    they are left as they are. The scale is chosen on the device, so the
    step never waits for g. It writes the grads' tensors (a DTensor's
    local shard) in place and applies nothing to the params."""

    def init(params):
        del params
        return EmptyState()

    @torch.no_grad()
    def update(grads, state, params):
        leaves = tree.leaves(grads)
        g = global_norm(leaves)
        scale = torch.where(g < max_norm, 1.0, max_norm / g)
        torch._foreach_mul_(
            [t.to_local() if isinstance(t, DTensor) else t
             for t in leaves], scale)
        return params, state

    return GradientTransformation(init, update, applies=False)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """optax.chain: each transformation's update in turn, threading a
    tuple of their states. Every one but the last must only rescale the
    grads (``applies`` False): once a step is applied to the params, a
    later transformation could no longer change it."""
    if not txs:
        raise ValueError("chain needs at least one transformation")
    if any(tx.applies for tx in txs[:-1]):
        raise ValueError("in a chain only the last transformation may "
                         "apply the update to the params")

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params):
        states = []
        for tx, s in zip(txs, state):
            params, s = tx.update(grads, s, params)
            states.append(s)
        return params, tuple(states)

    return GradientTransformation(init, update, applies=txs[-1].applies)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: bias-corrected moments,
    ``u = mu_hat / (sqrt(nu_hat) + eps)``, then ``p -= learning_rate *
    u``: `adamw`'s arithmetic with no decay term."""
    return _adam(learning_rate, b1, b2, eps, weight_decay=0.0)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax.adamw: bias-corrected moments,
    ``u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p``, then
    ``p -= learning_rate * u``. The decay is decoupled and applies to
    every leaf, biases and layer norms included (optax's ``mask=None``)."""
    return _adam(learning_rate, b1, b2, eps, weight_decay)


def _adam(learning_rate: float, b1: float, b2: float, eps: float,
          weight_decay: float) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(count=0, mu=_zeros(params),
                                nu=_zeros(params))

    @torch.no_grad()
    def update(grads, state, params):
        g, p = tree.leaves(grads), tree.leaves(params)
        mu, nu = tree.leaves(state.mu), tree.leaves(state.nu)
        count = state.count + 1
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(u, denom)
        if weight_decay:
            torch._foreach_add_(u, p, alpha=weight_decay)
        torch._foreach_add_(p, u, alpha=-learning_rate)
        return params, ScaleByAdamState(count=count, mu=state.mu,
                                        nu=state.nu)

    return GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: float | None = None
        ) -> GradientTransformation:
    """optax.sgd: ``p -= learning_rate * u`` with ``u = g``, or with
    momentum optax's trace ``t = g + momentum * t`` (no dampening) and
    ``u = t``."""

    def init(params):
        return TraceState(trace=None if momentum is None
                          else _zeros(params))

    @torch.no_grad()
    def update(grads, state, params):
        g, p = tree.leaves(grads), tree.leaves(params)
        u = g
        if momentum is not None:
            u = tree.leaves(state.trace)
            torch._foreach_mul_(u, momentum)
            torch._foreach_add_(u, g)
        torch._foreach_add_(p, u, alpha=-learning_rate)
        return params, state

    return GradientTransformation(init, update)
