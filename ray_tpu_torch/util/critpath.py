"""Critical-path analysis over the merged span timeline.

Walks the spans of one traced execution (a compiled-DAG run, a
pipeline step, a serve request — anything sharing a trace_id) and
returns the BLOCKING CHAIN: the sequence of spans where each entry is
the latest-finishing work that had to complete before the next could
start, with per-edge slack (idle gap between predecessor end and
successor start). Aggregated across executions, the chain answers
"where does p99 live" in one call (reference: the per-stage bubble
attribution that Podracer/MPMD-pipeline papers do by hand over
profiler dumps).

Spans are the TaskEventLog dicts that ride the task_events lane:
``{"name", "cat", "ph": "X", "ts": <epoch µs>, "dur": <µs>,
"node"?, "proc"?, "args": {"trace_id": ...}}``. Only complete
("ph" == "X") spans with a duration participate.
"""

from __future__ import annotations

# Two spans separated by less than this (µs) are treated as
# contiguous: scheduler handoff jitter, not real slack.
_EPS_US = 50.0


def _trace_of(span: dict) -> str:
    args = span.get("args") or {}
    return args.get("trace_id") or ""


def _complete(spans) -> list[dict]:
    return [s for s in spans
            if s.get("ph", "X") == "X" and float(s.get("dur") or 0) > 0]


def critical_path(spans, trace_id: str | None = None) -> dict:
    """Blocking chain of one execution.

    Returns ``{"trace_id", "chain": [{name, node, proc, ts, dur_ms,
    slack_ms}...], "e2e_ms", "path_ms", "coverage", "slowest"}`` where
    `coverage` is the fraction of the measured end-to-end window the
    chain's spans cover (union of intervals — overlapping parent/child
    entries are not double counted) and `slowest` names the chain
    entry with the largest duration.
    """
    if trace_id:
        spans = [s for s in spans if _trace_of(s) == trace_id]
    spans = _complete(spans)
    if not spans:
        return {"trace_id": trace_id or "", "chain": [], "e2e_ms": 0.0,
                "path_ms": 0.0, "coverage": 0.0, "slowest": None}
    start = min(float(s["ts"]) for s in spans)
    end = max(float(s["ts"]) + float(s["dur"]) for s in spans)
    e2e_us = max(0.0, end - start)

    def s_end(s):
        return float(s["ts"]) + float(s["dur"])

    # walk backwards from the latest-finishing span: the predecessor of
    # a chain entry is the latest-finishing span that ended at or
    # before the entry started (what it plausibly waited on); when
    # nothing precedes it cleanly, fall back to an overlapping span
    # that started earlier (a covering parent), then stop.
    cur = max(spans, key=s_end)
    chain_rev = [cur]
    while True:
        t0 = float(cur["ts"])
        preds = [s for s in spans
                 if s is not cur and s_end(s) <= t0 + _EPS_US]
        if not preds:
            preds = [s for s in spans
                     if s is not cur and float(s["ts"]) < t0 - _EPS_US
                     and s_end(s) < s_end(cur)]
            if not preds:
                break
        cur = max(preds, key=s_end)
        chain_rev.append(cur)
    chain_spans = list(reversed(chain_rev))

    chain = []
    prev_end = None
    for s in chain_spans:
        t0, dur = float(s["ts"]), float(s["dur"])
        slack = 0.0 if prev_end is None else max(0.0, t0 - prev_end)
        chain.append({
            "name": s.get("name", ""),
            "cat": s.get("cat", ""),
            "node": s.get("node", ""),
            "proc": s.get("proc", ""),
            "ts": t0,
            "dur_ms": round(dur / 1e3, 3),
            "slack_ms": round(slack / 1e3, 3),
        })
        prev_end = max(prev_end or 0.0, t0 + dur)

    # coverage: union of the chain's intervals over the e2e window
    ivals = sorted((float(s["ts"]), s_end(s)) for s in chain_spans)
    covered = 0.0
    cur_lo = cur_hi = None
    for lo, hi in ivals:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo

    slowest = max(chain, key=lambda c: c["dur_ms"]) if chain else None
    return {
        "trace_id": trace_id if trace_id is not None else _trace_of(
            chain_spans[-1]),
        "chain": chain,
        "e2e_ms": round(e2e_us / 1e3, 3),
        "path_ms": round(sum(c["dur_ms"] for c in chain), 3),
        "coverage": round(covered / e2e_us, 4) if e2e_us > 0 else 0.0,
        "slowest": slowest["name"] if slowest else None,
    }


def aggregate(spans, min_spans: int = 2) -> dict:
    """Critical paths of EVERY trace in a span dump, aggregated by
    chain-entry name: which work blocks executions, how often, and for
    how much total/mean/max time. Traces with fewer than `min_spans`
    complete spans are skipped (a lone span has no chain).

    Returns ``{"traces": N, "entries": [{name, count, total_ms,
    mean_ms, max_ms, share}...]}`` sorted by total blocking time;
    `share` is the fraction of summed path time the entry accounts
    for — "where does p99 live" reads off the top row.
    """
    by_trace: dict[str, list] = {}
    for s in _complete(spans):
        t = _trace_of(s)
        if t:
            by_trace.setdefault(t, []).append(s)
    agg: dict[str, dict] = {}
    n_traces = 0
    for t, group in by_trace.items():
        if len(group) < min_spans:
            continue
        n_traces += 1
        for entry in critical_path(group)["chain"]:
            a = agg.setdefault(entry["name"], {
                "name": entry["name"], "count": 0, "total_ms": 0.0,
                "max_ms": 0.0})
            a["count"] += 1
            a["total_ms"] += entry["dur_ms"]
            a["max_ms"] = max(a["max_ms"], entry["dur_ms"])
    total = sum(a["total_ms"] for a in agg.values()) or 1.0
    entries = []
    for a in sorted(agg.values(), key=lambda x: -x["total_ms"]):
        entries.append({
            "name": a["name"], "count": a["count"],
            "total_ms": round(a["total_ms"], 3),
            "mean_ms": round(a["total_ms"] / a["count"], 3),
            "max_ms": round(a["max_ms"], 3),
            "share": round(a["total_ms"] / total, 4),
        })
    return {"traces": n_traces, "entries": entries}
