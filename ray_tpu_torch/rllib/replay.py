"""Replay buffers — prioritized (segment tree): the port's copy of
``ray_tpu/rllib/replay.py`` (numpy); the uniform ring is `ReplayBuffer`
in ``dqn.py``, as in the JAX package.

Reference parity: rllib/utils/replay_buffers/prioritized_episode_buffer
and the classic proportional PER machinery
(rllib/execution/segment_tree.py): O(log n) sum-tree sampling with
importance weights w_i = (N * P(i))^-beta / max_w, priorities updated
from TD errors after each learner step. Vectorized numpy tree (one
array, level arithmetic) instead of a node-object tree.
"""

from __future__ import annotations

import numpy as np


class SumTree:
    """Flat binary sum tree over `capacity` leaves (power-of-two padded).
    tree[1] is the total mass; leaf i lives at `self._leaf0 + i`."""

    def __init__(self, capacity: int):
        self._leaf0 = 1
        while self._leaf0 < capacity:
            self._leaf0 *= 2
        self.tree = np.zeros(2 * self._leaf0, np.float64)
        self.capacity = capacity

    def set(self, idx, value):
        idx = np.atleast_1d(np.asarray(idx, np.int64)) + self._leaf0
        self.tree[idx] = np.asarray(value, np.float64)
        parents = np.unique(idx // 2)
        while parents.size:
            self.tree[parents] = (self.tree[2 * parents] +
                                  self.tree[2 * parents + 1])
            parents = np.unique(parents // 2)
            parents = parents[parents >= 1]

    def total(self) -> float:
        return float(self.tree[1])

    def sample(self, prefix_sums: np.ndarray) -> np.ndarray:
        """Vector of prefix sums -> leaf indices (proportional)."""
        idx = np.ones(len(prefix_sums), np.int64)
        mass = np.asarray(prefix_sums, np.float64).copy()
        while idx[0] < self._leaf0:
            left = self.tree[2 * idx]
            go_right = mass > left
            mass = np.where(go_right, mass - left, mass)
            idx = 2 * idx + go_right
        return idx - self._leaf0


class PrioritizedReplayBuffer:
    """Proportional PER over transition dicts (reference:
    prioritized_episode_buffer.py / segment_tree.py)."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        self.capacity = capacity
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._tree = SumTree(capacity)
        self._storage: dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._max_priority = 1.0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add_batch(self, batch: dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v)
                self._storage[k] = np.zeros((self.capacity, *v.shape[1:]),
                                            v.dtype)
        idxs = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idxs] = v
        # new transitions get max priority so they are seen at least once
        self._tree.set(idxs, self._max_priority ** self.alpha)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        total = self._tree.total()
        seg = total / batch_size
        prefix = (np.arange(batch_size) + self._rng.random(batch_size)) * seg
        idxs = self._tree.sample(np.minimum(prefix, total - 1e-9))
        idxs = np.minimum(idxs, self._size - 1)
        probs = self._tree.tree[self._tree._leaf0 + idxs] / total
        weights = (self._size * probs) ** (-self.beta)
        weights = weights / weights.max()
        out = {k: v[idxs] for k, v in self._storage.items()}
        out["weights"] = weights.astype(np.float32)
        out["idxs"] = idxs
        return out

    def update_priorities(self, idxs: np.ndarray, td_errors: np.ndarray):
        prio = np.abs(np.asarray(td_errors, np.float64)) + self.eps
        self._max_priority = max(self._max_priority, float(prio.max()))
        self._tree.set(np.asarray(idxs, np.int64), prio ** self.alpha)
