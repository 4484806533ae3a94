"""MetricsLogger — hierarchical, windowed metric reduction: the port's
copy of ``ray_tpu/rllib/metrics.py`` (pure Python).

Reference parity: rllib/utils/metrics/metrics_logger.py (nested key
paths, per-key reduce method + sliding window, lifetime sums via
reduce=sum with window=None).
"""

from __future__ import annotations

from collections import deque
from typing import Any


class _Stat:
    """window=None keeps O(1) LIFETIME accumulators per reduce kind —
    never an unbounded value list."""

    __slots__ = ("values", "reduce", "lifetime", "count", "windowed")

    def __init__(self, reduce: str, window: int | None):
        self.reduce = reduce
        self.windowed = window is not None
        self.values = deque(maxlen=window) if self.windowed else None
        self.lifetime = (float("inf") if reduce == "min"
                         else float("-inf") if reduce == "max" else 0.0)
        self.count = 0


def _to_path(key) -> tuple:
    if isinstance(key, tuple):
        return key
    if isinstance(key, str) and "/" in key:
        return tuple(key.split("/"))
    return (key,)


class MetricsLogger:
    def __init__(self):
        self._stats: dict[tuple, _Stat] = {}

    def log_value(self, key, value, reduce: str = "mean",
                  window: int | None = 100):
        """reduce in {mean, sum, min, max}; window=None means LIFETIME
        (reference: lifetime stats) — tracked with O(1) accumulators,
        never an unbounded buffer."""
        path = _to_path(key)
        st = self._stats.get(path)
        if st is None:
            st = self._stats[path] = _Stat(reduce, window)
        v = float(value)
        if not st.windowed:
            st.count += 1
            if st.reduce == "min":
                st.lifetime = min(st.lifetime, v)
            elif st.reduce == "max":
                st.lifetime = max(st.lifetime, v)
            else:  # sum and mean both accumulate a running sum
                st.lifetime += v
            return
        st.values.append(v)

    def log_dict(self, metrics: dict, key=None, **kwargs):
        prefix = _to_path(key) if key is not None else ()
        for k, v in metrics.items():
            if isinstance(v, dict):
                self.log_dict(v, key=prefix + _to_path(k), **kwargs)
            else:
                self.log_value(prefix + _to_path(k), v, **kwargs)

    def peek(self, key) -> Any:
        return self._reduce_one(self._stats[_to_path(key)])

    @staticmethod
    def _reduce_one(st: _Stat):
        if not st.windowed:
            if st.count == 0:
                return float("nan")
            if st.reduce == "mean":
                return st.lifetime / st.count
            return st.lifetime
        if st.reduce == "sum":
            return float(sum(st.values))
        if not st.values:
            return float("nan")
        if st.reduce == "mean":
            return float(sum(st.values) / len(st.values))
        if st.reduce == "min":
            return float(min(st.values))
        if st.reduce == "max":
            return float(max(st.values))
        raise ValueError(f"unknown reduce {st.reduce!r}")

    def reduce(self) -> dict:
        """Nested dict of reduced values (the per-iteration result)."""
        out: dict = {}
        for path, st in self._stats.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = self._reduce_one(st)
        return out
