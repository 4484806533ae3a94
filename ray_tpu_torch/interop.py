"""Convert the JAX package's parameter trees into the port's, and back.

A tree is nested dicts whose leaves are arrays: JAX arrays or numpy
arrays, with the stacked ``[L, ...]`` block leaves the JAX models build
(``ray_tpu/models/gpt2.py`` `init_gpt2`, ``ray_tpu/models/llama.py``
`init_llama`, whose block leaves are arrays directly under their
names). Every leaf goes through a
float32 numpy array, so bf16 leaves need no ``ml_dtypes`` here. Torch
seeds cannot reproduce ``jax.random`` draws, so this is how a test
makes both sides compute with the same weights. On a mesh,
``parallel.sharding.shard_pytree(params_from_jax(t), rules, mesh)``
lays converted params out as DTensors, and `params_to_numpy` gathers
them back. The RL models' trees (lists of layers, conv layers whose
stride is static) go through `rl_params_from_jax` and
`rl_params_to_jax`: the trees of ``init_mlp_policy`` (IMPALA, APPO,
OPE), the catalog's modules, SAC's ``{"pi", "q1", "q2"}`` and
DreamerV3's ``{"wm", "actor", "critic"}`` with its GRU and conv
encoder. A JAX train state with optax's adam or adamw state becomes the
port's `TrainState` through `train_state_from_jax` (the optimizer state
through `opt_state_from_optax`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def params_from_jax(tree: Any) -> Any:
    """Nested dict of array-likes -> nested dict of float32 CPU torch
    tensors, same keys (move or cast them with ``.to``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts (and lists or tuples) of torch tensors -> the same
    structure of float32 numpy arrays (the inverse of
    `params_from_jax`). Each array is a copy, which later in-place
    updates of the tensors leave alone. A DTensor leaf is gathered whole
    first (a collective: every rank must call it)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().to("cpu", torch.float32, copy=True).numpy()


def rl_params_from_jax(tree: Any) -> tuple[Any, tuple[int, ...]]:
    """An RL model's tree from the JAX package (``ray_tpu/rllib/models.py``,
    ``catalog.py``) -> (the port's tree of float32 CPU tensors, the conv
    strides in layer order, () without convs). Dicts keep their keys and
    lists of ``{"w", "b"}`` layers stay lists; a conv layer (the JAX
    package's ``ConvLayer``, read by its attributes ``w``, ``b`` and
    ``stride``) becomes ``{"w", "b"}`` with its HWIO kernel in OIHW, and
    its stride goes to the strides."""
    strides: list[int] = []

    def conv(layer) -> bool:
        return all(hasattr(layer, a) for a in ("w", "b", "stride"))

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(one(v) for v in t)
        if conv(t):
            strides.append(int(t.stride))
            return {"w": params_from_jax(t.w).permute(3, 2, 0, 1)
                    .contiguous(), "b": params_from_jax(t.b)}
        return params_from_jax(t)

    return one(tree), tuple(strides)


def rl_params_to_jax(tree: Any, strides=()) -> Any:
    """The inverse of `rl_params_from_jax`, over a tree of tensors or of
    host arrays (a learner's ``get_weights()``): host float32 numpy
    copies in the JAX package's layout, each conv layer (a ``{"w", "b"}`` under a
    ``"conv"`` key) as ``{"w": HWIO, "b", "stride"}`` with the strides
    in order, so a port checkpoint's weights can be held against a JAX
    learner's (whose ``ConvLayer`` carries the same three names)."""
    it = iter(strides)

    def host(t):
        if isinstance(t, torch.Tensor):
            return params_to_numpy(t)
        return np.array(t, dtype=np.float32)

    def one(t, in_conv=False):
        if isinstance(t, dict):
            if in_conv:
                return {"w": host(t["w"]).transpose(2, 3, 1, 0).copy(),
                        "b": host(t["b"]), "stride": next(it)}
            return {k: one(v, k == "conv") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(one(v, in_conv) for v in t)
        return host(t)

    return one(tree)


def opt_state_from_optax(opt_state: Any):
    """optax's ``adam`` / ``adamw`` state -> the port's `ScaleByAdamState`.

    optax keeps a chain's states in a tuple: ``ScaleByAdamState(count,
    mu, nu)`` first, then an ``EmptyState`` for each stateless part (the
    decay, a constant learning rate). The port's `adam`/`adamw` keep the
    one `ScaleByAdamState`, with `count` a host int and the moments as
    float32 CPU tensors. Read by attribute: this module imports no
    optax."""
    from ray_tpu_torch.train.optim import ScaleByAdamState

    states = opt_state if isinstance(opt_state, tuple) and not hasattr(
        opt_state, "mu") else (opt_state,)
    adam = [s for s in states if all(hasattr(s, a)
                                     for a in ("count", "mu", "nu"))]
    rest = [s for s in states if all(s is not a for a in adam)]
    if len(adam) != 1 or any(len(s) for s in rest):
        raise ValueError("not an optax adam/adamw state: want one "
                         "ScaleByAdamState beside empty states, got "
                         f"{[type(s).__name__ for s in states]}")
    s = adam[0]
    return ScaleByAdamState(count=int(np.asarray(s.count)),
                            mu=params_from_jax(s.mu),
                            nu=params_from_jax(s.nu))


def train_state_from_jax(state: Any):
    """A JAX package `TrainState` (params, optax adam/adamw state, a 0-d
    step array) -> the port's `TrainState` on the CPU, float32, with a
    host-int step and no accumulation buffer."""
    from ray_tpu_torch.train.spmd import TrainState

    return TrainState(params=params_from_jax(state.params),
                      opt_state=opt_state_from_optax(state.opt_state),
                      step=int(np.asarray(state.step)))
