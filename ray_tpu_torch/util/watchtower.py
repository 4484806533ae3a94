"""Watchtower — head-side metric history, SLO rules, structured alerts.

The metrics plane (cluster scrape) and the attribution plane (waterfalls,
spans) are scrape-on-demand: nothing retains history and nothing watches
the cluster between scrapes, so a replica flap or a queue ramp is
invisible until an operator happens to run
`ray_tpu_torch.scripts.cli metrics`. Watchtower closes that gap —
reference shape: the always-on health evaluation Podracer/RLAX-class
systems run next to their gangs, plus the
Prometheus alerting-rule state machine (pending → firing → resolved):

- **Metric history.** A head-side loop samples the head's own
  `_cluster_metrics_text()` aggregation (the cluster scrape fan-out, so
  sampling costs one extra consumer, not a second scrape plane) every
  `period_s` (default 5s) into bounded per-series ring buffers. Total
  series are capped (overflow COUNTED, never unbounded); per-series
  depth is a ring. Exposed as `util.state.cluster_metrics_history()`
  and the head `metrics_history` RPC — the time-series substrate
  rate/derivative rules and an SLO autoscaler both need.
- **Rule engine.** Declarative `WatchRule`s evaluated each sample tick
  against the history: threshold, rate-of-change, and absence/staleness
  predicates, each with a `for_s` hold-down (condition must hold that
  long before pending promotes to firing). `default_rules()` ships a
  pack covering the existing metric catalog end-to-end.
- **Structured alerts.** Fingerprinted, deduplicated `Alert`s with a
  pending → firing → resolved state machine and a bounded transition
  history, surfaced four ways: `watchtower_alerts_firing{severity}` /
  `watchtower_alerts_total{rule}` in the metric catalog,
  `util.state.alerts()` + the `ray_tpu_torch.scripts.cli alerts` CLI,
  an `alerts.json` artifact in `debug-dump`, and spans under the `watchtower` category
  on the merged timeline.
- **Alert-triggered flight recorder.** The first critical-severity
  firing transition can auto-invoke `debug_dump` (off by default;
  `RAY_TPU_WATCHTOWER_AUTODUMP` or a head knob), rate-limited to once
  per cooldown window — the post-mortem is captured while the incident
  is live instead of after the operator notices.

Everything runs on the watchtower's own thread: nothing here touches
the request hot path, and the `metrics_history`/`alerts` RPC handlers
only read state already gathered (they never RPC back into their own
server — the GL013 shape).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
import time
from collections import deque

# ------------------------------------------------------------------ parsing

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

# series key: (metric name, tuple(sorted (label, value) pairs))
SeriesKey = tuple


def parse_prometheus(text: str) -> dict[SeriesKey, float]:
    """Sample lines of one exposition page → {(name, tags): value}.
    Histogram `_bucket`/`_sum`/`_count` lines parse as ordinary series
    (the `le` tag included), which is exactly what quantile rules need.
    Unparsable lines and non-numeric values are skipped."""
    out: dict[SeriesKey, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, raw_tags, raw_val = m.groups()
        try:
            value = float(raw_val)
        except ValueError:
            continue
        tags = tuple(sorted(_LABEL_RE.findall(raw_tags))) if raw_tags \
            else ()
        out[(name, tags)] = value
    return out


# ------------------------------------------------------------------ history

class MetricHistory:
    """Bounded per-series ring buffers over sampled exposition pages.

    Memory contract: at most `max_series` retained series (a NEW series
    arriving past the cap is dropped and COUNTED in
    `dropped_series_total`; known series always update) × at most
    `samples_per_series` (t, value) points each — the window is a ring,
    oldest samples age out. Not thread-safe on its own: the owning
    Watchtower serializes access under its lock."""

    def __init__(self, max_series: int = 4096,
                 samples_per_series: int = 240):
        self.max_series = max_series
        self.samples_per_series = samples_per_series
        self._series: dict[SeriesKey, deque] = {}
        self.dropped_series_total = 0

    def append(self, t: float, samples: dict[SeriesKey, float]) -> None:
        for key, value in samples.items():
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series_total += 1
                    continue
                ring = self._series[key] = deque(
                    maxlen=self.samples_per_series)
            ring.append((t, value))

    @property
    def series_count(self) -> int:
        return len(self._series)

    def prune(self, min_t: float) -> int:
        """Evict series whose NEWEST sample predates `min_t` — they
        vanished from the scrape (node died, replica replaced). Without
        this, label churn (fresh node ids per boot) fills the series
        cap permanently and the watchtower goes silently blind to
        every series born after saturation. Returns the evict count
        (bookkept separately from cap rejections)."""
        dead = [k for k, ring in self._series.items()
                if ring and ring[-1][0] < min_t]
        for k in dead:
            del self._series[k]
        return len(dead)

    def series(self, name: str, labels: dict | None = None
               ) -> list[tuple[dict, deque]]:
        """All retained series of `name` whose tags contain `labels`
        (subset match); [(tags_dict, ring)] — rings are NOT copied."""
        out = []
        for (n, tags), ring in self._series.items():
            if n != name:
                continue
            td = dict(tags)
            if labels and any(td.get(k) != v for k, v in labels.items()):
                continue
            out.append((td, ring))
        return out

    def window(self, ring: deque, now: float, window_s: float
               ) -> list[tuple[float, float]]:
        lo = now - window_s
        return [(t, v) for t, v in ring if t >= lo]

    def query(self, names=None, window_s: float | None = None,
              now: float | None = None) -> list[dict]:
        """[{name, tags, samples: [[t, v], ...]}] for `names` (all
        retained series when None), clipped to the trailing window."""
        if now is None:
            now = time.monotonic()
        wanted = set(names) if names else None
        out = []
        for (name, tags), ring in self._series.items():
            if wanted is not None and name not in wanted:
                continue
            pts = list(ring) if window_s is None else \
                self.window(ring, now, window_s)
            if pts:
                out.append({"name": name, "tags": dict(tags),
                            "samples": [[t, v] for t, v in pts]})
        return out


# ------------------------------------------------------------------ rules

@dataclasses.dataclass
class WatchRule:
    """One declarative watch predicate, evaluated every sample tick.

    kind:
      - "threshold": `stat` over `window_s` compared against
        `threshold` with `op`;
      - "rate": per-second change of the aggregated series over
        `window_s` (counters: monotone rate with reset clamp; gauges:
        slope — the queue-ramp detector) compared with `op`;
      - "absence": staleness — seconds since the (counter) series last
        INCREASED; fires when >= `window_s` and the series showed
        activity before (a cluster that never trained never alerts).
        Firing is bounded by `resolve_after_s` (default 3x window_s):
        past that staleness the workload is considered ENDED, not
        stalled, and the alert resolves — a normally-completed train
        run must not page critical forever.

    stat (threshold kind): "last" (latest value), "p50"/"p99"
    (histogram quantile from `<metric>_bucket` deltas over the window),
    "skew" (p99/p50 of the same deltas — the straggler signal), or
    "hit_ratio" (rate(metric) / (rate(metric) + rate(ratio_metric)),
    gated on `min_rate` combined events/s so an idle cache never
    alerts).

    `for_s` is the hold-down: the condition must hold continuously that
    long before pending promotes to firing (one flappy sample never
    pages). `agg` folds multiple series (nodes/replicas) into the one
    evaluated value."""

    name: str
    metric: str
    kind: str = "threshold"        # threshold | rate | absence
    op: str = ">"                  # > | >= | < | <=
    threshold: float = 0.0
    window_s: float = 60.0
    for_s: float = 0.0
    severity: str = "warning"      # info | warning | critical
    stat: str = "last"             # last | p50 | p99 | skew | hit_ratio
    agg: str = "sum"               # sum | max | min | avg
    ratio_metric: str | None = None
    min_rate: float = 0.0
    labels: dict | None = None
    description: str = ""
    resolve_after_s: float = 0.0  # absence: 0 = 3x window_s

    def compare(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == ">=":
            return value >= self.threshold
        if self.op == "<":
            return value < self.threshold
        if self.op == "<=":
            return value <= self.threshold
        raise ValueError(f"bad op {self.op!r}")


def _agg(values: list[float], how: str) -> float | None:
    if not values:
        return None
    if how == "sum":
        return sum(values)
    if how == "max":
        return max(values)
    if how == "min":
        return min(values)
    if how == "avg":
        return sum(values) / len(values)
    raise ValueError(f"bad agg {how!r}")


def _series_rate(pts: list[tuple[float, float]],
                 counter: bool) -> float | None:
    """Per-second change over the window's endpoints. Counter resets
    (value decreased — the process restarted) yield None for the
    window rather than a huge negative rate."""
    if len(pts) < 2:
        return None
    (t0, v0), (t1, v1) = pts[0], pts[-1]
    if t1 <= t0:
        return None
    if counter and v1 < v0:
        return None
    return (v1 - v0) / (t1 - t0)


def _rate(history: MetricHistory, metric: str, labels, now: float,
          window_s: float, agg: str, counter: bool = True
          ) -> float | None:
    rates = []
    for _tags, ring in history.series(metric, labels):
        r = _series_rate(history.window(ring, now, window_s), counter)
        if r is not None:
            rates.append(r)
    return _agg(rates, agg)


def _bucket_deltas(history: MetricHistory, metric: str, labels,
                   now: float, window_s: float) -> list[tuple[float, float]]:
    """[(le, observations landed in that bucket over the window)],
    cumulative in `le` order, summed across every matching series —
    the rate() + sum by (le) a Prometheus quantile query would do."""
    per_le: dict[float, float] = {}
    for tags, ring in history.series(metric + "_bucket", labels):
        le_raw = tags.get("le")
        if le_raw is None:
            continue
        le = float("inf") if le_raw in ("+Inf", "inf") else float(le_raw)
        pts = history.window(ring, now, window_s)
        if len(pts) < 2:
            continue
        delta = pts[-1][1] - pts[0][1]
        if delta < 0:  # counter reset
            continue
        per_le[le] = per_le.get(le, 0.0) + delta
    return sorted(per_le.items())


def _quantile(buckets: list[tuple[float, float]], q: float
              ) -> float | None:
    """Linear-interpolated quantile over cumulative bucket deltas
    (histogram_quantile semantics). None when no observations landed in
    the window."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= rank:
            if le == float("inf"):
                return prev_le  # open-ended top bucket: its lower edge
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return buckets[-1][0]


def evaluate_rule(rule: WatchRule, history: MetricHistory,
                  now: float) -> tuple[float | None, bool]:
    """One rule against the history at `now` → (value, condition).
    value is None when the window holds no usable data — the rule
    neither fires nor resolves on silence (except `absence`, where
    silence after activity IS the signal)."""
    if rule.kind == "absence":
        staleness = None
        for _tags, ring in history.series(rule.metric, rule.labels):
            pts = list(ring)
            last_inc = None
            for i in range(len(pts) - 1, 0, -1):
                if pts[i][1] > pts[i - 1][1]:
                    last_inc = pts[i][0]
                    break
            if last_inc is None:
                # no increase inside the ring: activity (a nonzero
                # counter) predates the retained window entirely
                if pts and pts[-1][1] > 0 and \
                        now - pts[0][0] >= rule.window_s:
                    last_inc = pts[0][0] - rule.window_s
                else:
                    continue
            s = now - last_inc
            if staleness is None or s > staleness:
                staleness = s
        if staleness is None:
            return None, False
        # quiet-for-too-long is "ended", not "stalled": past the
        # resolve horizon the alert clears instead of firing forever
        # after every normally-completed run
        horizon = rule.resolve_after_s or 3 * rule.window_s
        return staleness, rule.window_s <= staleness < horizon

    if rule.kind == "rate":
        # gauges ramp down too: no reset clamp (counter=False keeps a
        # draining queue's negative slope meaningful for "<" rules)
        value = _rate(history, rule.metric, rule.labels, now,
                      rule.window_s, rule.agg,
                      counter=rule.metric.endswith("_total"))
        return value, value is not None and rule.compare(value)

    # threshold kind, by stat
    if rule.stat == "last":
        values = []
        for _tags, ring in history.series(rule.metric, rule.labels):
            pts = history.window(ring, now, rule.window_s)
            if pts:
                values.append(pts[-1][1])
        value = _agg(values, rule.agg)
    elif rule.stat in ("p50", "p99"):
        buckets = _bucket_deltas(history, rule.metric, rule.labels,
                                 now, rule.window_s)
        value = _quantile(buckets, 0.5 if rule.stat == "p50" else 0.99)
    elif rule.stat == "skew":
        buckets = _bucket_deltas(history, rule.metric, rule.labels,
                                 now, rule.window_s)
        p50 = _quantile(buckets, 0.5)
        p99 = _quantile(buckets, 0.99)
        value = (p99 / p50) if p50 and p99 is not None else None
    elif rule.stat == "hit_ratio":
        hits = _rate(history, rule.metric, rule.labels, now,
                     rule.window_s, "sum")
        misses = _rate(history, rule.ratio_metric or "", rule.labels,
                       now, rule.window_s, "sum")
        if hits is None and misses is None:
            value = None
        else:
            total = (hits or 0.0) + (misses or 0.0)
            value = None if total < rule.min_rate or total <= 0 \
                else (hits or 0.0) / total
    else:
        raise ValueError(f"bad stat {rule.stat!r}")
    return value, value is not None and rule.compare(value)


def default_rules() -> list[WatchRule]:
    """The shipped rule pack — one watcher per failure mode the metric
    catalog can already express (see OBSERVABILITY.md "Alerting" for
    the table + rationale). Thresholds are deliberately conservative:
    a rule that cries wolf gets disabled, and then nothing watches."""
    ttft_target_ms = float(os.environ.get(
        "RAY_TPU_WATCHTOWER_TTFT_SLO_MS", "2000"))
    return [
        WatchRule(
            "serve-ttft-slo-burn", metric="serve_slo_ttft_ms",
            stat="p99", labels={"phase": "total"}, op=">",
            threshold=ttft_target_ms, window_s=60, for_s=15,
            severity="critical",
            description="serve TTFT p99 over the SLO target "
                        f"({ttft_target_ms:g}ms) — the autoscaler "
                        "signal, escalated"),
        WatchRule(
            "serve-queue-ramp", metric="serve_llm_queue_depth",
            kind="rate", agg="sum", op=">", threshold=0.2,
            window_s=45, for_s=15, severity="warning",
            description="aggregate serve queue depth ramping "
                        ">0.2 req/s sustained — demand outrunning "
                        "decode capacity"),
        WatchRule(
            "replica-flapping", metric="serve_replica_restarts_total",
            kind="rate", agg="sum", op=">", threshold=3 / 180.0,
            window_s=180, for_s=0, severity="critical",
            description="replica replacements faster than 3 per 3min "
                        "— the self-healing loop is churning, not "
                        "healing"),
        WatchRule(
            "span-plane-overload", metric="spans_dropped_total",
            kind="rate", agg="sum", op=">", threshold=100.0,
            window_s=30, for_s=10, severity="warning",
            description="span plane dropping >100 spans/s — the "
                        "timeline is lossy; lower span rates or raise "
                        "the sampling cap"),
        WatchRule(
            "prefix-cache-thrash",
            metric="serve_llm_prefix_cache_hits_total",
            stat="hit_ratio",
            ratio_metric="serve_llm_prefix_cache_misses_total",
            op="<", threshold=0.2, min_rate=50.0, window_s=60,
            for_s=20, severity="warning",
            description="prefix-cache hit ratio collapsed under 20% "
                        "at >=50 pages/s — working set outgrew the "
                        "pool (thrash)"),
        WatchRule(
            "spec-accept-collapse",
            metric="serve_llm_spec_accepted_total",
            stat="hit_ratio",
            ratio_metric="serve_llm_spec_rejected_total",
            op="<", threshold=0.2, min_rate=50.0, window_s=60,
            for_s=20, severity="warning",
            description="speculative accept ratio collapsed under 20% "
                        "at >=50 proposed drafts/s — the proposer "
                        "stopped predicting this workload; every "
                        "verify step is wasted width"),
        WatchRule(
            "train-straggler", metric="train_step_seconds",
            stat="skew", op=">", threshold=2.0, window_s=120,
            for_s=30, severity="warning",
            description="train step p99/p50 skew >2x — a straggler "
                        "rank is gating the gang"),
        WatchRule(
            "train-stall", metric="train_step_seconds_count",
            kind="absence", window_s=120, for_s=0,
            severity="critical",
            description="train step counter stopped increasing for "
                        "2min after prior activity — a hung gang "
                        "(deadlocked collective, dead worker)"),
        WatchRule(
            "train-pipeline-bubble",
            metric="train_pipeline_bubble_ratio",
            stat="last", agg="max", op=">", threshold=0.5,
            window_s=60, for_s=60, severity="warning",
            description="pipeline bubble ratio >0.5 sustained 60s — "
                        "more than half the stage-seconds are idle; "
                        "the microbatch count is mis-sized for the "
                        "stage count (raise M toward "
                        "bubble=(S-1)/(S-1+M)) or a stage is a "
                        "straggler"),
        WatchRule(
            "train-zero-gather-stall",
            metric="train_zero_gather_share",
            stat="last", agg="max", op=">",
            threshold=float(os.environ.get(
                "RAY_TPU_WATCHTOWER_GATHER_SHARE", "0.35")),
            window_s=60, for_s=30, severity="warning",
            description="all-gather share of the train step over "
                        "RAY_TPU_WATCHTOWER_GATHER_SHARE (default "
                        "0.35) sustained 30s with zero_stage >= 3 — "
                        "the just-in-time param gather dominates the "
                        "step; drop to stage 2 or widen the per-chip "
                        "batch to amortize it"),
        WatchRule(
            "log-error-spike", metric="log_records_total",
            kind="rate", agg="sum", labels={"level": "error"},
            op=">", threshold=float(os.environ.get(
                "RAY_TPU_WATCHTOWER_LOG_ERRORS_PER_S", "5.0")),
            window_s=30, for_s=10, severity="warning",
            description="error-level log records faster than "
                        "RAY_TPU_WATCHTOWER_LOG_ERRORS_PER_S (default "
                        "5/s) sustained — something is failing "
                        "repeatedly; the firing alert carries the last "
                        "error lines as context"),
        WatchRule(
            "task-queue-stall", metric="task_queue_wait_seconds",
            stat="p99", op=">", threshold=float(os.environ.get(
                "RAY_TPU_WATCHTOWER_QUEUE_WAIT_P99_S", "5.0")),
            window_s=60, for_s=60, severity="warning",
            description="task queue-wait p99 over "
                        "RAY_TPU_WATCHTOWER_QUEUE_WAIT_P99_S (default "
                        "5s) sustained 60s — the dispatch queue is "
                        "stalling; `ray_tpu_torch.scripts.cli explain "
                        "<task_id>` names "
                        "the unsatisfiable constraint for the head of "
                        "the queue"),
        WatchRule(
            "object-stranded-refs",
            metric="object_store_stranded_bytes",
            stat="last", agg="sum", op=">",
            threshold=float(os.environ.get(
                "RAY_TPU_WATCHTOWER_STRANDED_BYTES",
                str(128 << 20))),
            window_s=120, for_s=30, severity="warning",
            description="owned refs past the stranded-age threshold "
                        "with no consumer progress are holding more "
                        "bytes than RAY_TPU_WATCHTOWER_STRANDED_BYTES "
                        "(default 128MB) — the stranded-oid leak "
                        "shape; `ray_tpu_torch.scripts.cli memory` names the "
                        "owner/creator"),
    ]


# ------------------------------------------------------------------ alerts

class AlertState:
    PENDING = "pending"
    FIRING = "firing"
    RESOLVED = "resolved"


class Alert:
    """One deduplicated alert instance: a rule's condition holding.
    Fingerprint = rule name + the rule's label filter, so repeated
    condition-true ticks UPDATE the one alert instead of multiplying
    it (the dedup contract)."""

    __slots__ = ("rule", "severity", "state", "fingerprint", "value",
                 "threshold", "since", "firing_since", "resolved_at",
                 "description", "context")

    def __init__(self, rule: WatchRule, value: float, now_wall: float):
        self.rule = rule.name
        self.severity = rule.severity
        self.state = AlertState.PENDING
        self.fingerprint = alert_fingerprint(rule)
        self.value = value
        self.threshold = rule.threshold
        self.since = now_wall
        self.firing_since: float | None = None
        self.resolved_at: float | None = None
        self.description = rule.description
        # last-N error-level log lines attached at the firing
        # transition (bounded; None until/unless the alert fires with a
        # log_context_fn wired)
        self.context: list[dict] | None = None

    def to_dict(self) -> dict:
        out = {"rule": self.rule, "severity": self.severity,
               "state": self.state, "fingerprint": self.fingerprint,
               "value": self.value, "threshold": self.threshold,
               "since": self.since, "firing_since": self.firing_since,
               "resolved_at": self.resolved_at,
               "description": self.description}
        if self.context is not None:
            out["context"] = self.context
        return out


def alert_fingerprint(rule: WatchRule) -> str:
    basis = f"{rule.name}|{sorted((rule.labels or {}).items())}"
    return hashlib.blake2s(basis.encode(), digest_size=6).hexdigest()


# ---------------------------------------------------------------- watchtower

class Watchtower:
    """The head's always-on watcher: sample → retain → evaluate → alert.

    `scrape` is the head's `_cluster_metrics_text` (sampling reuses the
    existing scrape fan-out); `span_sink` is the head's `_ingest_spans`
    (alert transitions land on the merged timeline under the
    `watchtower` category); `dump_fn(out_dir)` overrides the autodump
    action (tests; default runs `util.state.debug_dump` against
    `address_fn()`). All mutable state is guarded by `_lock`; the RPC
    handlers the head registers only read under it."""

    def __init__(self, scrape, period_s: float | None = None,
                 rules: list[WatchRule] | None = None,
                 max_series: int | None = None,
                 samples_per_series: int | None = None,
                 autodump: str | bool | None = None,
                 autodump_cooldown_s: float | None = None,
                 address_fn=None, span_sink=None, dump_fn=None,
                 history_limit: int = 200,
                 series_ttl_s: float | None = None,
                 log_context_fn=None, log_context_n: int = 20):
        self._scrape = scrape
        self._address_fn = address_fn
        self._span_sink = span_sink
        self._dump_fn = dump_fn
        # log_context_fn(n) -> last n error-level log records; attached
        # to alerts at their firing transition (fetched OUTSIDE the
        # lock — it is an RPC fan-out on the head)
        self._log_context_fn = log_context_fn
        self._log_context_n = log_context_n
        if period_s is None:
            period_s = float(os.environ.get(
                "RAY_TPU_WATCHTOWER_PERIOD_S", "5.0"))
        if os.environ.get("RAY_TPU_WATCHTOWER", "1") in ("0", "off"):
            period_s = 0.0
        self.period_s = period_s
        self.rules = list(default_rules() if rules is None else rules)
        self._lock = threading.Lock()
        self.history = MetricHistory(  # guarded_by(_lock)
            max_series=max_series or int(os.environ.get(
                "RAY_TPU_WATCHTOWER_MAX_SERIES", "4096")),
            samples_per_series=samples_per_series or int(os.environ.get(
                "RAY_TPU_WATCHTOWER_SAMPLES", "240")))
        # series that miss this many seconds of scrapes are pruned
        # (dead nodes/replicas free their cap slots for new series)
        self.series_ttl_s = (series_ttl_s if series_ttl_s is not None
                             else max(300.0, 60 * (period_s or 5.0)))
        self._active: dict[str, Alert] = {}  # guarded_by(_lock)
        self._transitions = deque(maxlen=history_limit)  # guarded_by(_lock)
        self._samples_total = 0  # guarded_by(_lock)
        self._published: dict[str, int] = {}  # guarded_by(_lock)
        # epoch anchor so RPC surfaces report wall-clock timestamps
        # while windows/holds run on the monotonic clock
        self._anchor = time.time() - time.monotonic()
        if autodump is None:
            autodump = os.environ.get("RAY_TPU_WATCHTOWER_AUTODUMP", "")
        if autodump in ("", "0", False, None, "off"):
            self._autodump_dir = None
        elif autodump in ("1", True, "on"):
            self._autodump_dir = "ray_tpu_torch-autodump"
        else:
            self._autodump_dir = str(autodump)
        self._autodump_cooldown_s = (
            autodump_cooldown_s if autodump_cooldown_s is not None
            else float(os.environ.get(
                "RAY_TPU_WATCHTOWER_AUTODUMP_COOLDOWN_S", "600")))
        self._last_autodump: float | None = None  # guarded_by(_lock)
        self.autodumps = 0  # guarded_by(_lock)
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="watchtower")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Watchtower":
        if self.period_s > 0:
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self.period_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001
                pass  # a failed scrape skips one tick, never the loop

    # ------------------------------------------------------------- sampling

    def sample_once(self, now: float | None = None) -> None:
        """One tick: scrape → parse → retain → evaluate. `now` is a
        monotonic-seconds override for deterministic tests. The scrape
        happens OUTSIDE the lock (it is an RPC fan-out)."""
        text = self._scrape()
        if now is None:
            now = time.monotonic()
        samples = parse_prometheus(text)
        dump_requests: list[str] = []
        fired: list[Alert] = []
        with self._lock:
            self.history.append(now, samples)
            self.history.prune(now - self.series_ttl_s)
            self._samples_total += 1
            self._evaluate_locked(now, dump_requests, fired)
            self._publish_metrics_locked()
        if fired and self._log_context_fn is not None:
            # attach the last error-level log lines as bounded context.
            # Fetched OUTSIDE the lock (it is an RPC fan-out); a failed
            # fetch just leaves the alert context-less.
            try:
                context = self._log_context_fn(self._log_context_n)
            except Exception:  # noqa: BLE001
                context = None
            if context:
                with self._lock:
                    for alert in fired:
                        alert.context = context[-self._log_context_n:]
        for rule_name in dump_requests:
            self._spawn_autodump(rule_name)

    # ----------------------------------------------------------- evaluation

    def _evaluate_locked(self, now: float, dump_requests: list[str],
                         fired: list["Alert"] | None = None) -> None:
        now_wall = now + self._anchor
        for rule in self.rules:
            try:
                value, cond = evaluate_rule(rule, self.history, now)
            except Exception:  # noqa: BLE001
                continue  # a broken rule must not take down the tick
            fp = alert_fingerprint(rule)
            alert = self._active.get(fp)
            if cond:
                if alert is None:
                    alert = Alert(rule, value, now_wall)
                    self._active[fp] = alert
                    self._transition_locked(alert, None,
                                            AlertState.PENDING, now)
                    # zero hold-down promotes on the same tick
                alert.value = value
                if alert.state == AlertState.PENDING and \
                        now_wall - alert.since >= rule.for_s:
                    alert.state = AlertState.FIRING
                    alert.firing_since = now_wall
                    if fired is not None:
                        fired.append(alert)
                    self._transition_locked(alert, AlertState.PENDING,
                                            AlertState.FIRING, now)
                    if rule.severity == "critical" and \
                            self._autodump_dir is not None:
                        if self._last_autodump is None or \
                                now - self._last_autodump >= \
                                self._autodump_cooldown_s:
                            self._last_autodump = now
                            self.autodumps += 1
                            dump_requests.append(rule.name)
            elif alert is not None:
                # condition cleared OR the signal went silent: pending
                # quietly de-escalates, firing resolves. A vanished
                # signal resolving (rather than latching) is
                # deliberate — an alert that can never resolve is an
                # alert nobody re-trusts; the transition history still
                # records that it fired.
                prev = alert.state
                alert.state = AlertState.RESOLVED
                alert.resolved_at = now_wall
                self._active.pop(fp, None)
                self._transition_locked(alert, prev,
                                        AlertState.RESOLVED, now)

    def _transition_locked(self, alert: Alert, prev: str | None,
                           state: str, now: float) -> None:
        self._transitions.append({
            "t": now + self._anchor, "rule": alert.rule,
            "fingerprint": alert.fingerprint, "from": prev,
            "to": state, "value": alert.value,
            "severity": alert.severity})
        if state == AlertState.FIRING:
            from ray_tpu_torch.util.metrics import Counter

            Counter("watchtower_alerts_total",
                    "Alert pending->firing transitions, by rule",
                    tag_keys=("rule",)).inc(tags={"rule": alert.rule})
        if self._span_sink is not None:
            from ray_tpu_torch.utils.events import epoch_us

            try:
                self._span_sink([{
                    "name": f"watchtower.{alert.rule}",
                    "cat": "watchtower", "ph": "X", "ts": epoch_us(),
                    "dur": 1.0, "node": "head", "proc": "watchtower",
                    "tid": 0,
                    "args": {"from": prev, "to": state,
                             "value": alert.value,
                             "severity": alert.severity}}])
            except Exception:  # noqa: BLE001
                pass

    def _publish_metrics_locked(self) -> None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        firing = Gauge("watchtower_alerts_firing",
                       "Alerts currently firing, by severity",
                       tag_keys=("severity",))
        counts = {"info": 0, "warning": 0, "critical": 0}
        for a in self._active.values():
            if a.state == AlertState.FIRING:
                counts[a.severity] = counts.get(a.severity, 0) + 1
        for sev, n in counts.items():
            firing.set(n, tags={"severity": sev})
        Gauge("watchtower_series",
              "Metric-history series currently retained"
              ).set(self.history.series_count)
        # counters publish DELTAS since the last tick (the registry is
        # process-shared: several in-process heads may feed one counter)
        def delta(counter, total, key):
            d = total - self._published.get(key, 0)
            if d > 0:
                counter.inc(d)
                self._published[key] = total

        delta(Counter("watchtower_series_dropped_total",
                      "New series rejected by the history series cap"),
              self.history.dropped_series_total, "dropped")
        delta(Counter("watchtower_samples_total",
                      "Metric-history sample ticks completed"),
              self._samples_total, "samples")
        delta(Counter("watchtower_autodumps_total",
                      "Debug dumps auto-triggered by critical alerts"),
              self.autodumps, "dumps")

    # ------------------------------------------------------------- autodump

    def _spawn_autodump(self, rule_name: str) -> None:
        """Fire-and-forget flight recording on its own thread — the
        sampling loop must keep ticking while the dump (up to its
        deadline) gathers artifacts. Rate limiting already happened
        under the lock at the firing transition."""
        stamp = time.strftime("%Y%m%d-%H%M%S")
        out_dir = os.path.join(self._autodump_dir,
                               f"{stamp}-{rule_name}")

        def run():
            try:
                if self._dump_fn is not None:
                    self._dump_fn(out_dir)
                else:
                    from ray_tpu_torch.util import state

                    state.debug_dump(
                        out_dir=out_dir,
                        address=self._address_fn()
                        if self._address_fn else None,
                        deadline_s=45.0)
            except Exception:  # noqa: BLE001
                pass  # best-effort, like every flight-recorder path

        threading.Thread(target=run, daemon=True,
                         name="watchtower-autodump").start()

    # ------------------------------------------------------------- surfaces

    def history_dict(self, names=None, window_s: float | None = None
                     ) -> dict:
        """The `metrics_history` RPC body: series samples with
        epoch-seconds timestamps, plus the bounds bookkeeping."""
        with self._lock:
            series = self.history.query(names, window_s)
            for s in series:
                s["samples"] = [[t + self._anchor, v]
                                for t, v in s["samples"]]
            return {"series": series, "period_s": self.period_s,
                    "series_count": self.history.series_count,
                    "series_dropped":
                        self.history.dropped_series_total,
                    "samples_total": self._samples_total}

    def alerts_dict(self, include_history: bool = True) -> dict:
        """The `alerts` RPC body: active (pending+firing) alerts plus
        the bounded transition history, and the rule pack itself so a
        consumer can show what is being watched."""
        with self._lock:
            out = {"alerts": [a.to_dict()
                              for a in self._active.values()],
                   "rules": [dataclasses.asdict(r)
                             for r in self.rules],
                   "autodumps": self.autodumps}
            if include_history:
                out["history"] = list(self._transitions)
            return out
