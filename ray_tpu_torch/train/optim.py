"""Optimizers with optax's names, defaults and arithmetic: `adamw` and
`sgd`, the port's counterparts of ``optax.adamw`` and ``optax.sgd``.

Each is a `GradientTransformation` with optax's two functions, one
difference in the second:

- ``init(params) -> state``;
- ``update(grads, state, params) -> (params, state)``: it applies the
  update itself, writing the new values into the params' tensors in
  place (what ``optax.apply_updates`` with a donated state does), with
  ``torch._foreach_*`` kernels over all leaves at once.

Trees are nested dicts of tensors (`ray_tpu_torch.util.tree`). The step
count lives on the host as an int, so the bias corrections are host
floats and an update never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ray_tpu_torch.util import tree


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


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


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax.adamw: bias-corrected moments,
    ``u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p``, then
    ``p -= learning_rate * u``. The decay is decoupled and applies to
    every leaf, biases and layer norms included (optax's ``mask=None``)."""

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
