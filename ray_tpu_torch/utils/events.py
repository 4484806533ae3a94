"""Task-event log → Chrome trace (reference: task events pipeline,
core_worker/task_event_buffer.h → `ray timeline`): the port's copy of
``ray_tpu/utils/events.py`` without its disk spill (`SpanSpill`) and the
cluster merge (`merge_spans`), which only the cluster runtime's head
reaches.

Timestamp contract (the epoch-anchoring rule every span producer must
follow, see OBSERVABILITY.md): spans are TIMED with the monotonic clock
(durations never go backwards under NTP slew) but STAMPED on the epoch
wall clock, via a wall−monotonic offset recorded once per process at
import. That makes `ts` values comparable across processes and nodes —
the property a merged cluster timeline needs — while `dur` stays a pure
monotonic difference. Chrome-trace units: microseconds for both.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

# Wall−monotonic offset in microseconds, sampled ONCE per process: every
# span in this process shares the same anchor, so intra-process ordering
# is exactly monotonic ordering; cross-process alignment is as good as
# the hosts' wall clocks (NTP-class, ~ms — plenty for locating a
# straggler in a multi-second train step).
_WALL_ANCHOR_US = time.time_ns() / 1e3 - time.monotonic_ns() / 1e3


def epoch_us(monotonic_ns: int | None = None) -> float:
    """Epoch-anchored microseconds for a monotonic_ns reading (now if
    omitted)."""
    if monotonic_ns is None:
        monotonic_ns = time.monotonic_ns()
    return monotonic_ns / 1e3 + _WALL_ANCHOR_US


def child_trace(parent: dict | None) -> dict:
    """New span context under `parent` (OTel-style propagation —
    reference: tracing_helper.py:34). A None parent starts a trace.
    Ids come from the runtime's fast per-thread PRNG: this runs on
    EVERY task submit, and os.urandom is a ~100us syscall on small
    virtualized guests."""
    from ray_tpu_torch.core.ids import _id_rng

    rng = _id_rng.rng
    span_id = rng.randbytes(8).hex()
    if parent is None:
        return {"trace_id": rng.randbytes(16).hex(), "span_id": span_id,
                "parent_id": None}
    return {"trace_id": parent["trace_id"], "span_id": span_id,
            "parent_id": parent["span_id"]}


class SpanSampler:
    """Per-category span rate limiting for the >10k tasks/s regime.

    Policy shape: ``{"max_per_s": float, "categories": {cat: float}}``
    — 0 (or a missing entry) means unlimited. Token-bucket per
    category, with one hard guarantee the tests pin: the FIRST span of
    every distinct (category, name) pair is always kept (so a sampled
    timeline still shows that a phase/task *exists* even when its rate
    is clamped). Drop/keep counts are tracked per category so nothing
    ever disappears silently.

    Off by default: `admit()` is only called when a policy with a
    nonzero limit is installed — the unsampled hot path stays one dict
    lookup + append, exactly as before.
    """

    def __init__(self, policy: dict | None = None):
        self.policy = policy or {}
        self._buckets: dict[str, list[float]] = {}  # cat -> [tokens, t]
        self._seen: set[tuple[str, str]] = set()

    def limit_for(self, category: str) -> float:
        cats = self.policy.get("categories") or {}
        return float(cats.get(category,
                              self.policy.get("max_per_s", 0.0)) or 0.0)

    def admit(self, name: str, category: str, now: float) -> bool:
        """Caller holds the owning log's lock."""
        rate = self.limit_for(category)
        if rate <= 0:
            return True
        key = (category, name)
        if key not in self._seen:
            if len(self._seen) < 8192:  # bounded first-seen memory
                self._seen.add(key)
                return True
            # set full (high-cardinality names — per-task ids): the
            # first-seen guarantee is exhausted; fall THROUGH to the
            # bucket, or unbounded fresh names would bypass sampling
            # entirely in exactly the flood regime this exists for
        bucket = self._buckets.get(category)
        if bucket is None:
            bucket = self._buckets[category] = [rate, now]
        tokens, t_last = bucket
        tokens = min(rate, tokens + (now - t_last) * rate)
        if tokens >= 1.0:
            bucket[0] = tokens - 1.0
            bucket[1] = now
            return True
        bucket[0] = tokens
        bucket[1] = now
        return False


class TaskEventLog:
    def __init__(self, capacity: int = 100_000):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._capacity = capacity
        self._sampler: SpanSampler | None = None  # guarded_by(_lock)
        # per-category kept/dropped counts since the last counter sync
        # (plain ints under the existing lock: the hot path must not pay
        # a metrics-registry lock per span)
        self._kept: dict[str, int] = {}  # guarded_by(_lock)
        self._dropped: dict[str, int] = {}  # guarded_by(_lock)

    def configure_sampling(self, policy: dict | None) -> None:
        """Install (or clear, with None/empty) a sampling policy:
        ``{"max_per_s": N, "categories": {cat: N}}``, 0 = unlimited.
        Head-driven: workers poll the head's `span_policy` and install
        whatever it answers, so one knob at the head throttles every
        producer."""
        with self._lock:
            self._sampler = SpanSampler(policy) if policy else None

    @contextlib.contextmanager
    def span(self, name: str, category: str, trace: dict | None = None):
        """`trace` carries the propagated {trace_id, span_id, parent_id}
        context (reference: opentelemetry span propagation,
        ray/util/tracing/tracing_helper.py:34) — recorded as chrome-trace
        args so cross-process spans of one logical request correlate."""
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.record(name, category, t0, time.monotonic_ns(),
                        trace=trace)

    def record(self, name: str, category: str, t0_ns: int,
               t1_ns: int | None = None, trace: dict | None = None):
        """Append one completed span timed by the caller (monotonic_ns
        endpoints); `ts` is epoch-anchored at append. Subject to the
        sampling policy (when one is installed) and the capacity bound;
        rejected spans are COUNTED per category, never silently lost."""
        if t1_ns is None:
            t1_ns = time.monotonic_ns()
        ev = {
            "name": name,
            "cat": category,
            "ph": "X",
            "ts": epoch_us(t0_ns),
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": 0,
            "tid": threading.get_ident(),
        }
        if trace:
            ev["args"] = dict(trace)
        with self._lock:
            if self._sampler is not None and not self._sampler.admit(
                    name, category, t1_ns / 1e9):
                self._dropped[category] = \
                    self._dropped.get(category, 0) + 1
                return
            if len(self._events) >= self._capacity:
                self._dropped[category] = \
                    self._dropped.get(category, 0) + 1
                return
            self._kept[category] = self._kept.get(category, 0) + 1
            self._events.append(ev)

    def span_counts(self) -> tuple[dict[str, int], dict[str, int]]:
        """(kept, dropped) per category since construction/last reset —
        the raw numbers behind spans_sampled_total/spans_dropped_total."""
        with self._lock:
            return dict(self._kept), dict(self._dropped)

    def sync_metrics(self) -> None:
        """Publish kept/dropped deltas into the process metrics registry
        (`spans_sampled_total` / `spans_dropped_total`, tagged by
        category). Called from flush loops — NOT the record hot path —
        so sampling accounting costs nothing per span."""
        with self._lock:
            kept = {k: v for k, v in self._kept.items() if v}
            dropped = {k: v for k, v in self._dropped.items() if v}
            self._kept.clear()
            self._dropped.clear()
        if not kept and not dropped:
            return
        from ray_tpu_torch.util.metrics import Counter

        m_kept = Counter(
            "spans_sampled_total",
            "Spans admitted into the local span buffer, by category",
            tag_keys=("category",))
        m_drop = Counter(
            "spans_dropped_total",
            "Spans rejected by the sampling policy or a full buffer, "
            "by category", tag_keys=("category",))
        for cat, n in kept.items():
            m_kept.inc(n, tags={"category": cat})
        for cat, n in dropped.items():
            m_drop.inc(n, tags={"category": cat})

    def drain(self) -> list[dict]:
        """Take (and clear) the buffered spans — the flush primitive:
        workers/drivers drain into the head's cluster-wide span buffer."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def requeue(self, events: list[dict]) -> None:
        """Put drained spans back (a flush whose delivery failed must
        not lose them); capacity still bounds the buffer."""
        if not events:
            return
        with self._lock:
            room = max(0, self._capacity - len(self._events))
            self._events[:0] = events[-room:] if room else []

    def chrome_trace(self, filename: str | None = None):
        with self._lock:
            events = list(self._events)
        if filename:
            with open(filename, "w") as f:
                json.dump(events, f)
            return filename
        return events
