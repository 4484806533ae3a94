"""Metrics: counters, gauges and histograms over a per-process registry.

The port's own copy of the metric types of ``ray_tpu/util/metrics.py``
(`Registry`, `Counter`, `Gauge`, `Histogram`), of its Prometheus
exposition of one process's registry (`prometheus_text`) and of the
cluster scrape plane's export half: `inject_labels` and
`merge_prometheus` (a page a node, stamped with its origin),
`scrape_pages` (the head's and nodelet's fan-out) and
`serve_metrics_http` (the /metrics page)."""

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


def prometheus_text(registry: "Registry | None" = None) -> str:
    """A registry's metrics in Prometheus exposition format (the
    process-default registry when none is given)."""
    lines: list[str] = []
    for m in (registry or _registry).collect():
        lines.extend(m.expose())
    return "\n".join(lines) + "\n"


def inject_labels(sample_line: str, tags: dict) -> str:
    """Add labels to one exposition SAMPLE line (`name 1` or
    `name{a="b"} 1`) — how the cluster aggregator stamps each scraped
    page with its origin (node=..., proc=...) without touching the
    producing process's registry. A key the series already carries is
    left alone (duplicate label names are invalid exposition format
    and would fail the whole scrape)."""
    if not tags:
        return sample_line
    if "{" in sample_line:
        import re as _re

        head, sep, value = sample_line.rpartition("} ")
        if not sep:
            return sample_line
        items = [(k, v) for k, v in sorted(tags.items())
                 # exact label-name match only: `node=` must not be
                 # shadowed by a series that carries `src_node=`
                 if not _re.search(rf'[{{,]{_re.escape(k)}="', head)]
        if not items:
            return sample_line
        extra = ",".join(f'{k}="{v}"' for k, v in items)
        return f"{head},{extra}}} {value}"
    name, sep, value = sample_line.partition(" ")
    if not sep:
        return sample_line
    extra = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    return f"{name}{{{extra}}} {value}"


def merge_prometheus(pages: list[tuple[dict, str]]) -> str:
    """Merge scraped exposition pages into one, injecting each page's
    origin tags into its sample lines. Samples are GROUPED BY FAMILY
    with the HELP/TYPE header emitted once above all of them — standard
    Prometheus parsers require a family's samples contiguous under its
    header (interleaving families demotes them to untyped). Within a
    page, samples belong to the most recent header's family (the shape
    prometheus_text() and this function itself both emit, so merges
    compose). Series stay distinct because every page carries
    distinguishing tags (node/proc)."""
    order: list[str] = []
    headers: dict[str, list[str]] = {}
    samples: dict[str, list[str]] = {}

    def family(fam: str) -> str:
        if fam not in samples:
            order.append(fam)
            samples[fam] = []
            headers.setdefault(fam, [])
        return fam

    for tags, text in pages:
        current = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3:
                    current = family(parts[2])
                    directive = parts[1]  # HELP / TYPE, one each
                    if not any(h.split(None, 3)[1] == directive
                               for h in headers[current]):
                        headers[current].append(line)
                continue
            fam = current
            if fam is None:  # headerless sample: its own family
                fam = family(line.split("{", 1)[0].split(" ", 1)[0])
            samples[fam].append(inject_labels(line, tags))
    out: list[str] = []
    for fam in order:
        out.extend(headers.get(fam, ()))
        out.extend(samples[fam])
    return "\n".join(out) + "\n"


def scrape_pages(client, targets: list[tuple[str, str]], method: str,
                 timeout_s: float, tag_key: str) -> list[tuple[dict, str]]:
    """Concurrently scrape `method` (a handler returning {"text": ...})
    from (tag_value, address) targets under ONE shared deadline — a
    slow or dead target costs the whole scrape at most `timeout_s`, not
    timeout_s apiece (RpcClient.call_gather also reclaims timed-out
    reply slots, so repeated scrapes of a hung peer cannot leak).
    Shared by the head's node fan-out and the nodelet's worker
    fan-out."""
    results = client.call_gather(
        [(addr, method, {}) for _, addr in targets], timeout=timeout_s)
    pages: list[tuple[dict, str]] = []
    for (tag, _), r in zip(targets, results):
        if r is not None:  # dead/slow target: the rest of the page stands
            pages.append(({tag_key: tag}, r["text"]))
    return pages


def clear_registry():
    _registry.clear()


def serve_metrics_http(port: int = 0, text_fn=None) -> int:
    """Expose /metrics over HTTP (reference: metrics agent endpoint).
    `text_fn` overrides the page source — the head passes its
    cluster-wide aggregation so one port serves every node's metrics.
    Returns the bound port."""
    import http.server
    import threading as _t

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = (text_fn or prometheus_text)().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    _t.Thread(target=server.serve_forever, daemon=True,
              name="metrics-http").start()
    return server.server_address[1]
