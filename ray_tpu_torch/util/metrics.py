"""Metrics: counters, gauges and histograms over a per-process registry.

The port's own copy of the metric types of ``ray_tpu/util/metrics.py``
(`Registry`, `Counter`, `Gauge`, `Histogram`): the engine records its
serving metrics through them. The Prometheus exposition and the cluster
scrape plane come with the port of the core runtime."""

from __future__ import annotations

import threading
from typing import Sequence


class Registry:
    """A metric namespace. The module-level default serves the process
    (the reference shape); components that can share one process in
    tests (in-process nodelets of cluster_utils.Cluster) own a PRIVATE
    instance so same-named gauges never alias across components and
    per-node attribution stays exact."""

    def __init__(self):
        self._metrics: dict[str, "Metric"] = {}
        self._lock = threading.Lock()

    def register(self, m: "Metric"):
        with self._lock:
            existing = self._metrics.get(m.name)
            if existing is not None:
                return existing
            self._metrics[m.name] = m
            return m

    def collect(self) -> list["Metric"]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self):
        with self._lock:
            self._metrics.clear()


_registry = Registry()


def _fmt_tags(tags: dict | None) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    return "{" + inner + "}"


class Metric:
    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 registry: "Registry | None" = None):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        registered = (registry or _registry).register(self)
        self._shared_from = registered if registered is not self else None
        if self._shared_from is not None:
            # same-name re-creation shares state (reference behavior);
            # subclasses adopt their extra stores in _adopt_shared
            self._values = registered._values
            self._lock = registered._lock

    def _key(self, tags: dict | None) -> tuple:
        tags = tags or {}
        return tuple(tags.get(k, "") for k in self.tag_keys)

    def _tags_of(self, key: tuple) -> dict:
        return dict(zip(self.tag_keys, key))

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} {self.TYPE}"]
        with self._lock:
            items = list(self._values.items())
        if not items:
            lines.append(f"{self.name} 0")
        for key, v in items:
            lines.append(f"{self.name}{_fmt_tags(self._tags_of(key))} {v}")
        return lines


class Counter(Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    TYPE = "gauge"

    def set(self, value: float, tags: dict | None = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)

    def inc(self, value: float = 1.0, tags: dict | None = None):
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def dec(self, value: float = 1.0, tags: dict | None = None):
        self.inc(-value, tags)


class Histogram(Metric):
    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (),
                 tag_keys: Sequence[str] = (),
                 registry: "Registry | None" = None):
        self.boundaries = tuple(boundaries) or (
            0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)
        super().__init__(name, description, tag_keys, registry)
        shared = self._shared_from
        if shared is not None and isinstance(shared, Histogram):
            # observations must land in the registered instance's stores,
            # or re-created histograms silently drop data from /metrics
            self._counts = shared._counts
            self._sums = shared._sums
            self._totals = shared._totals
            self.boundaries = shared.boundaries
        else:
            self._counts: dict[tuple, list[int]] = {}
            self._sums: dict[tuple, float] = {}
            self._totals: dict[tuple, int] = {}

    def observe(self, value: float, tags: dict | None = None):
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def sum_total(self) -> float:
        """Sum of all observed values across every tag combination —
        the cheap 'how much time went here so far' probe waterfall
        snapshots diff."""
        with self._lock:
            return sum(self._sums.values())

    def sums_by_tag(self, tag_key: str) -> dict[str, float]:
        """Observed-value sums grouped by one tag's values (other tags
        summed over) — what lets the step waterfall split a phase into
        per-op buckets by diffing snapshots. Unknown tag key: {}."""
        try:
            i = self.tag_keys.index(tag_key)
        except ValueError:
            return {}
        with self._lock:
            out: dict[str, float] = {}
            for k, s in self._sums.items():
                out[k[i]] = out.get(k[i], 0.0) + s
            return out

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = list(self._counts)
            for k in keys:
                tags = self._tags_of(k)
                cum = 0
                for i, b in enumerate(self.boundaries):
                    cum += self._counts[k][i]
                    t = dict(tags, le=str(b))
                    lines.append(f"{self.name}_bucket{_fmt_tags(t)} {cum}")
                cum += self._counts[k][-1]
                t = dict(tags, le="+Inf")
                lines.append(f"{self.name}_bucket{_fmt_tags(t)} {cum}")
                lines.append(
                    f"{self.name}_sum{_fmt_tags(tags)} {self._sums[k]}")
                lines.append(
                    f"{self.name}_count{_fmt_tags(tags)} {self._totals[k]}")
        return lines
