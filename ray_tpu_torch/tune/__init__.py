"""ray_tpu_torch.tune — the port of ``ray_tpu.tune``, so far its
JAX-free pieces that RLlib's `Algorithm` stands on: the class-based
`Trainable` and the search-space markers (`grid_search` and the
`Domain` samplers) that an `AlgorithmConfig` refuses at ``build()``.
The Tuner and its schedulers run trials as actors and wait for the
runtime (ROADMAP.md)."""

from ray_tpu_torch.tune.search import (
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.trainable import Trainable

__all__ = [
    "Searcher",
    "TPESearcher",
    "Trainable",
    "choice",
    "grid_search",
    "loguniform",
    "randint",
    "uniform",
]
