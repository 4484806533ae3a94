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
them back.
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
    """Nested dict of torch tensors -> nested dict of float32 numpy
    arrays, same keys (the inverse of `params_from_jax`). Each array is
    a copy, which later in-place updates of the tensors leave alone. A
    DTensor leaf is gathered whole first (a collective: every rank must
    call it)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().to("cpu", torch.float32, copy=True).numpy()
