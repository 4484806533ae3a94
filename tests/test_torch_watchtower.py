"""Watchtower plane: metric history bounds, rule predicates, the alert
lifecycle, the four agreeing alert surfaces on a live cluster, and the
autodump rate limit — the scenarios of tests/test_watchtower.py (22) on
the port. Beside them:

- the Prometheus parser and every rule kind (threshold, rate,
  quantile, hit-ratio, absence) give the JAX package's values and
  verdicts on the same seeded sample streams, and the default rule
  pack is JAX's;
- the ZeRO-3 gather-stall rule fires on the port's own
  ``train_zero_gather_share`` gauge, set by an attributed ZeRO-3 step
  on a one-rank gloo mesh;
- `tracing.profiler_capture` is a no-op on a CPU device and raises on a
  CUDA device where there is no card (JAX yields None there), and raises
  when the block launched the port's kernels but the profiler's trace
  holds fewer of their device events, or none (a stub profiler stands in
  for the card's)."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from ray_tpu_torch.util.watchtower import (
    MetricHistory,
    WatchRule,
    Watchtower,
    default_rules,
    evaluate_rule,
    parse_prometheus,
)


def _key(name, **tags):
    return (name, tuple(sorted(tags.items())))


# ---------------------------------------------------------------------------
# parsing + ring-buffer bounds
# ---------------------------------------------------------------------------

def test_parse_prometheus_samples_and_buckets():
    text = (
        "# HELP q waiting\n# TYPE q gauge\n"
        'serve_llm_queue_depth{node="a"} 3\n'
        "serve_llm_queue_depth 5.5\n"
        'train_step_seconds_bucket{le="0.1"} 10\n'
        'train_step_seconds_bucket{le="+Inf"} 12\n'
        "train_step_seconds_count 12\n"
        "broken_line{ 1\n"
        "not_a_number nan_is_finefloat\n")
    s = parse_prometheus(text)
    assert s[_key("serve_llm_queue_depth", node="a")] == 3.0
    assert s[_key("serve_llm_queue_depth")] == 5.5
    # histogram internals retain as ordinary series (le included) —
    # the raw material for windowed quantiles
    assert s[_key("train_step_seconds_bucket", le="+Inf")] == 12.0
    assert _key("broken_line") not in s
    assert _key("not_a_number") not in s


def test_history_series_cap_counts_overflow():
    h = MetricHistory(max_series=3, samples_per_series=4)
    page = {_key("m", i=str(i)): float(i) for i in range(10)}
    h.append(0.0, page)
    assert h.series_count == 3
    assert h.dropped_series_total == 7
    # known series keep updating; new ones stay capped + counted
    h.append(1.0, page)
    assert h.series_count == 3
    assert h.dropped_series_total == 14


def test_history_per_series_ring_is_bounded():
    h = MetricHistory(max_series=8, samples_per_series=5)
    for t in range(50):
        h.append(float(t), {_key("m"): float(t)})
    [(tags, ring)] = h.series("m")
    assert len(ring) == 5
    assert [v for _, v in ring] == [45.0, 46.0, 47.0, 48.0, 49.0]
    # query respects the trailing window
    [row] = h.query(["m"], window_s=2.5, now=49.0)
    assert [v for _, v in row["samples"]] == [47.0, 48.0, 49.0]


# ---------------------------------------------------------------------------
# rule predicates
# ---------------------------------------------------------------------------

def _fill(h, name, values, dt=5.0, **tags):
    for i, v in enumerate(values):
        h.append(i * dt, {_key(name, **tags): float(v)})


def test_threshold_rule_last_value_aggregates_series():
    h = MetricHistory()
    _fill(h, "serve_llm_queue_depth", [1, 2, 3], node="a")
    _fill(h, "serve_llm_queue_depth", [4, 5, 9], node="b")
    r = WatchRule("q", metric="serve_llm_queue_depth", op=">",
                  threshold=10.0, window_s=30, agg="sum")
    value, cond = evaluate_rule(r, h, 10.0)
    assert value == 12.0 and cond
    r_max = WatchRule("q", metric="serve_llm_queue_depth", op=">",
                      threshold=10.0, window_s=30, agg="max")
    value, cond = evaluate_rule(r_max, h, 10.0)
    assert value == 9.0 and not cond


def test_rate_rule_counter_reset_clamp():
    h = MetricHistory()
    # a restart mid-window (value drops) must not produce a huge
    # negative (or positive) rate — the window yields no data instead
    _fill(h, "serve_replica_restarts_total", [100, 110, 3])
    r = WatchRule("flap", metric="serve_replica_restarts_total",
                  kind="rate", op=">", threshold=0.5, window_s=30)
    value, cond = evaluate_rule(r, h, 10.0)
    assert value is None and not cond
    # monotone growth evaluates normally: +20 over 10s = 2/s
    h2 = MetricHistory()
    _fill(h2, "serve_replica_restarts_total", [0, 10, 20])
    value, cond = evaluate_rule(r, h2, 10.0)
    assert value == pytest.approx(2.0) and cond


def test_rate_rule_gauge_slope_detects_ramp():
    h = MetricHistory()
    _fill(h, "serve_llm_queue_depth", [0, 4, 8, 12, 16], dt=2.0)
    r = WatchRule("ramp", metric="serve_llm_queue_depth", kind="rate",
                  op=">", threshold=0.5, window_s=60)
    value, cond = evaluate_rule(r, h, 8.0)
    assert value == pytest.approx(2.0) and cond
    # a draining queue (negative slope) does not fire a ">" rule
    h2 = MetricHistory()
    _fill(h2, "serve_llm_queue_depth", [16, 8, 0], dt=2.0)
    value, cond = evaluate_rule(r, h2, 4.0)
    assert value == pytest.approx(-4.0) and not cond


def test_quantile_rule_p99_and_skew_from_buckets():
    h = MetricHistory()
    # 90 obs <=0.1s, 9 more <=1s, 1 more <=10s over the window
    for t, scale in ((0.0, 0.0), (30.0, 1.0)):
        h.append(t, {
            _key("train_step_seconds_bucket", le="0.1"): 90 * scale,
            _key("train_step_seconds_bucket", le="1.0"): 99 * scale,
            _key("train_step_seconds_bucket", le="10.0"): 100 * scale,
            _key("train_step_seconds_bucket", le="+Inf"): 100 * scale,
        })
    p99 = WatchRule("s", metric="train_step_seconds", stat="p99",
                    op=">", threshold=0.5, window_s=60)
    value, cond = evaluate_rule(p99, h, 30.0)
    assert value == pytest.approx(1.0) and cond
    skew = WatchRule("s", metric="train_step_seconds", stat="skew",
                     op=">", threshold=2.0, window_s=60)
    value, cond = evaluate_rule(skew, h, 30.0)
    # p50 interpolates inside [0, 0.1); p99 lands at 1.0 -> skew >> 2
    assert value > 2.0 and cond
    # empty window (no new observations): no value, no firing
    value, cond = evaluate_rule(p99, h, 300.0)
    assert value is None and not cond


def test_hit_ratio_rule_gated_on_activity_floor():
    hits, misses = ("serve_llm_prefix_cache_hits_total",
                    "serve_llm_prefix_cache_misses_total")
    r = WatchRule("thrash", metric=hits, stat="hit_ratio",
                  ratio_metric=misses, op="<", threshold=0.2,
                  min_rate=50.0, window_s=60)
    h = MetricHistory()
    _fill(h, hits, [0, 50, 100])       # 10 pages/s hit
    _fill(h, misses, [0, 450, 900])    # 90 pages/s miss -> ratio 0.1
    value, cond = evaluate_rule(r, h, 10.0)
    assert value == pytest.approx(0.1) and cond
    # same collapse below the activity floor: an idle cache never pages
    h2 = MetricHistory()
    _fill(h2, hits, [0, 1, 2])
    _fill(h2, misses, [0, 9, 18])
    value, cond = evaluate_rule(r, h2, 10.0)
    assert value is None and not cond


def test_absence_rule_staleness_needs_prior_activity():
    r = WatchRule("stall", metric="train_step_seconds_count",
                  kind="absence", window_s=60)
    h = MetricHistory()
    # grows for 50s, then flat: stale once quiet for a window (but
    # still inside the 3x-window "ended" horizon)
    for t in range(0, 250, 5):
        h.append(float(t),
                 {_key("train_step_seconds_count"): float(min(t, 50))})
    value, cond = evaluate_rule(r, h, 150.0)
    assert cond and value >= 60.0
    # still actively increasing: not stale
    h2 = MetricHistory()
    for t in range(0, 250, 5):
        h2.append(float(t), {_key("train_step_seconds_count"): float(t)})
    value, cond = evaluate_rule(r, h2, 245.0)
    assert not cond
    # a cluster that never trained never alerts
    h3 = MetricHistory()
    for t in range(0, 250, 5):
        h3.append(float(t), {_key("train_step_seconds_count"): 0.0})
    value, cond = evaluate_rule(r, h3, 245.0)
    assert value is None and not cond


def test_absence_rule_resolves_past_the_ended_horizon():
    """A normally-completed run must not page critical forever: past
    resolve_after_s (default 3x window) staleness means ENDED, and the
    alert clears."""
    r = WatchRule("stall", metric="train_step_seconds_count",
                  kind="absence", window_s=60)
    h = MetricHistory(samples_per_series=1000)
    for t in range(0, 1000, 5):
        h.append(float(t),
                 {_key("train_step_seconds_count"): float(min(t, 50))})
    # inside [window, 3*window): stalled -> fires
    _, cond = evaluate_rule(r, h, 50.0 + 90.0)
    assert cond
    # past the horizon: ended -> resolves
    _, cond = evaluate_rule(r, h, 50.0 + 200.0)
    assert not cond


def test_history_prunes_vanished_series():
    """Dead nodes/replicas free their series-cap slots: a series whose
    newest sample predates the prune floor is evicted, so churn can
    never permanently blind the watchtower to NEW series."""
    h = MetricHistory(max_series=2)
    h.append(0.0, {_key("m", node="dead"): 1.0})
    h.append(0.0, {_key("m", node="live"): 1.0})
    h.append(100.0, {_key("m", node="live"): 2.0,
                     _key("m", node="new"): 1.0})
    assert h.dropped_series_total == 1  # "new" hit the cap
    assert h.prune(50.0) == 1  # "dead" evicted
    h.append(101.0, {_key("m", node="new"): 1.0})  # slot freed
    assert {t["node"] for t, _ in h.series("m")} == {"live", "new"}


def test_default_rule_pack_covers_catalog_signals():
    rules = {r.name: r for r in default_rules()}
    assert {"serve-ttft-slo-burn", "serve-queue-ramp",
            "replica-flapping", "span-plane-overload",
            "prefix-cache-thrash", "spec-accept-collapse",
            "train-straggler",
            "train-stall", "train-pipeline-bubble",
            "train-zero-gather-stall", "log-error-spike",
            "task-queue-stall", "object-stranded-refs"} == set(rules)
    for r in rules.values():
        assert r.severity in ("info", "warning", "critical")
        assert r.description


# ---------------------------------------------------------------------------
# alert lifecycle + dedup (driven tick-by-tick with injected time)
# ---------------------------------------------------------------------------

def _ticker(rule, **kw):
    """A Watchtower around one gauge we control; no sampling thread."""
    cur = {"v": 0.0}
    wt = Watchtower(lambda: f"test_gauge {cur['v']}\n", period_s=0,
                    rules=[rule], **kw)
    return wt, cur


def test_alert_lifecycle_pending_firing_resolved_dedup():
    rule = WatchRule("hot", metric="test_gauge", op=">", threshold=5.0,
                     window_s=10, for_s=4.0, severity="warning")
    wt, cur = _ticker(rule)
    states = []
    for t, v in enumerate([0, 9, 9, 9, 9, 9, 9, 0, 0]):
        cur["v"] = float(v)
        wt.sample_once(now=float(t * 2))
        active = wt.alerts_dict(include_history=False)["alerts"]
        assert len(active) <= 1  # dedup: one alert per rule fingerprint
        states.append(active[0]["state"] if active else "-")
    # condition true at t=2 -> pending; for_s=4 holds it until t=6
    assert states == ["-", "pending", "pending", "firing", "firing",
                      "firing", "firing", "-", "-"]
    d = wt.alerts_dict()
    assert [(e["from"], e["to"]) for e in d["history"]] == [
        (None, "pending"), ("pending", "firing"),
        ("firing", "resolved")]
    # firing counted once per transition, not per tick
    from ray_tpu_torch.util.metrics import prometheus_text

    assert 'watchtower_alerts_total{rule="hot"}' in prometheus_text()


def test_pending_that_clears_never_fires():
    rule = WatchRule("blip", metric="test_gauge", op=">", threshold=5.0,
                     window_s=10, for_s=6.0)
    wt, cur = _ticker(rule)
    for t, v in enumerate([9, 9, 0, 0]):
        cur["v"] = float(v)
        wt.sample_once(now=float(t * 2))
    d = wt.alerts_dict()
    assert d["alerts"] == []
    assert [e["to"] for e in d["history"]] == ["pending", "resolved"]
    assert all(e["to"] != "firing" for e in d["history"])


def test_task_queue_stall_rule_fires_and_resolves():
    """The flight-recorder rule: queue-wait p99 over the threshold for
    60s fires a warning; a burst of fast dispatches pulls the windowed
    p99 back under and resolves it. Driven synthetically from the
    cumulative bucket counts of `task_queue_wait_seconds`."""
    rule = {r.name: r for r in default_rules()}["task-queue-stall"]
    assert rule.severity == "warning" and rule.stat == "p99"
    counts = {"fast": 0, "slow": 0}  # <=1s vs (1s, 10s] observations

    def scrape():
        le1 = counts["fast"]
        le10 = counts["fast"] + counts["slow"]
        return (
            f'task_queue_wait_seconds_bucket{{le="1.0"}} {le1}\n'
            f'task_queue_wait_seconds_bucket{{le="10.0"}} {le10}\n'
            f'task_queue_wait_seconds_bucket{{le="+Inf"}} {le10}\n')

    wt = Watchtower(scrape, period_s=0, rules=[rule])
    states = []
    # (dt-advance handled via explicit now=) each tick is 30s apart
    for t, (fast, slow) in enumerate(
            [(0, 0), (0, 10), (0, 20), (0, 30), (1000, 30), (2000, 30)]):
        counts["fast"], counts["slow"] = fast, slow
        wt.sample_once(now=float(t * 30))
        active = wt.alerts_dict(include_history=False)["alerts"]
        states.append(active[0]["state"] if active else "-")
    # stalled dispatches land in the (1,10] bucket -> p99=10s > 5s:
    # pending at 30s, firing once held for_s=60, resolved when the
    # fast burst drags the windowed p99 under the threshold
    assert states == ["-", "pending", "pending", "firing", "-", "-"]
    d = wt.alerts_dict()
    assert [(e["from"], e["to"]) for e in d["history"]] == [
        (None, "pending"), ("pending", "firing"),
        ("firing", "resolved")]


def test_zero_gather_stall_rule_fires_and_resolves():
    """The ZeRO-3 rule: all-gather share of the train step held over
    the threshold for 30s fires a warning (the JIT param gathers are
    eating the step — drop to stage 2 or widen the data axis); the
    share falling back under resolves it. Driven synthetically from
    the train_zero_gather_share gauge."""
    rule = {r.name: r for r in default_rules()}["train-zero-gather-stall"]
    assert rule.severity == "warning"
    assert rule.metric == "train_zero_gather_share"
    cur = {"v": 0.0}
    wt = Watchtower(lambda: f"train_zero_gather_share {cur['v']}\n",
                    period_s=0, rules=[rule])
    states = []
    # healthy -> gather-bound (0.6 > 0.35) -> recovered; 15s ticks so
    # for_s=30 holds the pending state for two ticks before firing
    for t, v in enumerate([0.1, 0.6, 0.6, 0.6, 0.6, 0.1, 0.1]):
        cur["v"] = float(v)
        wt.sample_once(now=float(t * 15))
        active = wt.alerts_dict(include_history=False)["alerts"]
        states.append(active[0]["state"] if active else "-")
    assert states == ["-", "pending", "pending", "firing", "firing",
                      "-", "-"]
    d = wt.alerts_dict()
    assert [(e["from"], e["to"]) for e in d["history"]] == [
        (None, "pending"), ("pending", "firing"),
        ("firing", "resolved")]


def test_autodump_rate_limited_to_one_per_cooldown():
    rule = WatchRule("crit", metric="test_gauge", op=">", threshold=5.0,
                     window_s=10, for_s=0.0, severity="critical")
    dumps = []
    wt, cur = _ticker(rule, autodump="unused-dir",
                      autodump_cooldown_s=100.0,
                      dump_fn=lambda d: dumps.append(d))
    # three separate firing episodes inside one cooldown window
    pattern = [9, 9, 0, 9, 9, 0, 9, 9, 0]
    for t, v in enumerate(pattern):
        cur["v"] = float(v)
        wt.sample_once(now=float(t * 2))
    time.sleep(0.3)  # dump thread is fire-and-forget
    fired = [e for e in wt.alerts_dict()["history"]
             if e["to"] == "firing"]
    assert len(fired) == 3
    assert len(dumps) == 1 and wt.autodumps == 1
    # past the cooldown, the next firing dumps again
    cur["v"] = 9.0
    wt.sample_once(now=150.0)
    time.sleep(0.3)
    assert len(dumps) == 2 and wt.autodumps == 2


def test_autodump_off_by_default():
    rule = WatchRule("crit", metric="test_gauge", op=">", threshold=5.0,
                     window_s=10, for_s=0.0, severity="critical")
    dumps = []
    wt, cur = _ticker(rule, dump_fn=lambda d: dumps.append(d))
    cur["v"] = 9.0
    wt.sample_once(now=0.0)
    time.sleep(0.1)
    assert wt.autodumps == 0 and dumps == []


def test_warning_severity_never_autodumps():
    rule = WatchRule("warm", metric="test_gauge", op=">", threshold=5.0,
                     window_s=10, for_s=0.0, severity="warning")
    dumps = []
    wt, cur = _ticker(rule, autodump="somewhere",
                      dump_fn=lambda d: dumps.append(d))
    cur["v"] = 9.0
    wt.sample_once(now=0.0)
    time.sleep(0.1)
    assert dumps == []


def test_profiler_capture_noop_on_cpu(tmp_path):
    """On a CPU device the capture is a guarded no-op — nothing armed,
    nothing written, block still runs."""
    from ray_tpu_torch.util import tracing

    out = str(tmp_path / "prof")
    ran = []
    with tracing.profiler_capture(out, device="cpu") as captured:
        ran.append(1)
    assert ran == [1]
    assert captured is None
    assert not os.path.exists(out)
    with tracing.profiler_capture(None) as captured:
        assert captured is None


def test_profiler_capture_raises_on_cuda_without_a_card(tmp_path):
    """The port's deviation: asked for the card where there is none,
    the capture raises instead of running the block un-profiled."""
    import torch

    from ray_tpu_torch.util import tracing

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tracing.profiler_capture(str(tmp_path / "prof"),
                                      device="cuda"):
            pass
    assert not os.path.exists(tmp_path / "prof")


@pytest.mark.parametrize("launched,device_events,raises", [
    (3, 0, "no device event"),  # kernels ran, the trace saw none
    (3, 1, "1 of them"),        # the trace lost two of three records
    (3, 3, None),               # one device event a launch
    (0, 0, None),               # nothing launched: an empty trace is honest
])
def test_profiler_capture_raises_on_a_trace_without_device_events(
        tmp_path, monkeypatch, launched, device_events, raises):
    """After the export, a block that launched the port's kernels (their
    launch counters moved) but left fewer of their device events in the
    trace, or none, makes the capture raise instead of handing back the
    trace."""
    import torch
    import torch.profiler

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.util import tracing

    class StubProfile:
        """torch.profiler.profile on a schedule of one warm-up and one
        active step: the active step's end exports the trace."""

        def __init__(self, activities, schedule, on_trace_ready):
            self.on_trace_ready = on_trace_ready
            self.steps = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1
            if self.steps == 2:
                self.on_trace_ready(self)

        def export_chrome_trace(self, path):
            events = [{"name": "cudaLaunchKernel", "cat": "cuda_runtime",
                       "ts": 0, "dur": 1}]
            events += [{"name": "flash_fwd_bf16_kernel", "cat": "kernel",
                        "ts": 2 + i, "dur": 1}
                       for i in range(device_events)]
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile", StubProfile)
    monkeypatch.setattr(tracing, "_warm_up", lambda torch, device: None)
    # the stub's launches are undone after the test: later tests of this
    # process hold the counter at 0
    monkeypatch.setattr(fa.LAUNCHES, "count", fa.LAUNCHES.count)
    out = str(tmp_path / "prof")

    def capture():
        with tracing.profiler_capture(out, device="cuda") as path:
            for _ in range(launched):
                fa.LAUNCHES.add()
        return path

    if raises:
        with pytest.raises(RuntimeError, match=raises) as err:
            capture()
        assert f"{{'flash_fwd': {launched - device_events}}}" in \
            str(err.value)
    else:
        path = capture()
        assert tracing.device_events(path) == device_events
        assert tracing.kernel_events(path)["flash_fwd"] == device_events
    assert len(os.listdir(out)) == 1  # the trace is written either way


# ---------------------------------------------------------------------------
# parity with the JAX package on seeded sample streams
# ---------------------------------------------------------------------------

def _stream_pages(seed: int, ticks: int = 40) -> list[str]:
    """Seeded Prometheus pages over time: two nodes' gauge, a counter
    with a reset, a histogram's cumulative buckets, a cache's hit and
    miss counters, a counter that goes quiet, and a malformed line."""
    rng = np.random.RandomState(seed)
    pages = []
    cnt = hits = miss = quiet = 0.0
    buckets = np.zeros(4)
    for t in range(ticks):
        cnt = 0.0 if t == ticks // 2 else cnt + rng.randint(0, 20)
        hits += rng.randint(0, 30)
        miss += rng.randint(0, 30) * (t > ticks // 3)
        quiet += rng.randint(1, 5) if t < ticks // 4 else 0
        buckets += np.cumsum(rng.randint(0, 6, 4))
        lines = [f'g_depth{{node="a"}} {rng.rand() * 10 + t:.4f}',
                 f'g_depth{{node="b"}} {rng.rand() * 10:.4f}',
                 f"c_total {cnt}", f"hit_total {hits}",
                 f"miss_total {miss}", f"quiet_total {quiet}",
                 "broken{ 1"]
        for le, v in zip(("0.1", "1.0", "10.0", "+Inf"), buckets):
            lines.append(f'h_seconds_bucket{{le="{le}"}} {v}')
        pages.append("# TYPE g_depth gauge\n" + "\n".join(lines) + "\n")
    return pages


def _parity_rules(mod):
    R = mod.WatchRule
    return [
        R("thr-max", metric="g_depth", op=">", threshold=12.0,
          window_s=10, for_s=4.0, agg="max"),
        R("thr-sum", metric="g_depth", op=">=", threshold=20.0,
          window_s=10, severity="critical"),
        R("rate-ctr", metric="c_total", kind="rate", op=">",
          threshold=3.0, window_s=8, for_s=2.0),
        R("rate-gauge", metric="g_depth", kind="rate", op=">",
          threshold=0.5, window_s=6, labels={"node": "a"}),
        R("q-p99", metric="h_seconds", op=">", threshold=0.5,
          window_s=10, stat="p99"),
        R("q-p50", metric="h_seconds", op="<", threshold=5.0,
          window_s=10, stat="p50"),
        R("q-skew", metric="h_seconds", op=">", threshold=2.0,
          window_s=10, stat="skew"),
        R("hit", metric="hit_total", op="<", threshold=0.6,
          window_s=10, stat="hit_ratio", ratio_metric="miss_total",
          min_rate=1.0),
        R("absent", metric="quiet_total", kind="absence", op=">=",
          threshold=0.0, window_s=8, for_s=0.0, severity="critical"),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parser_and_rule_verdicts_match_jax(seed):
    """Each rule kind's (value, condition) at every tick, the alert
    states, and the parsed samples equal the JAX package's."""
    from ray_tpu.util import watchtower as jwt
    from ray_tpu_torch.util import watchtower as twt

    pages = _stream_pages(seed)
    out = {}
    for name, mod in (("jax", jwt), ("port", twt)):
        rules = _parity_rules(mod)
        hist = mod.MetricHistory()
        cur = {"p": ""}
        wt = mod.Watchtower(lambda: cur["p"], period_s=0, rules=rules)
        trace = []
        for t, page in enumerate(pages):
            now = float(t * 2)
            parsed = mod.parse_prometheus(page)
            hist.append(now, parsed)
            verdicts = [mod.evaluate_rule(r, hist, now) for r in rules]
            cur["p"] = page
            wt.sample_once(now=now)
            states = sorted((a["rule"], a["state"]) for a in
                            wt.alerts_dict(include_history=False)["alerts"])
            trace.append((sorted(parsed.items()), verdicts, states))
        out[name] = trace
    assert out["port"] == out["jax"]
    # the stream exercises every kind: some rule held, some did not
    held = {r for _, v, _ in out["port"] for r, (_, c) in enumerate(v) if c}
    assert len(held) >= 5, held


def test_default_rule_pack_matches_jax():
    from ray_tpu.util import watchtower as jwt

    def fields(r):
        # the descriptions name each package's own CLI
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k != "description"}

    want = [fields(r) for r in jwt.default_rules()]
    got = [fields(r) for r in default_rules()]
    assert got == want


def test_zero_gather_rule_fires_on_the_ports_gauge():
    """The rule reads the gauge the port's attributed ZeRO-3 step sets:
    a step whose host-observed all_gather share is 60 % (the loss
    records an all_gather round of the collective histogram) fires it;
    steps without one resolve it."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import PartitionRules
    from ray_tpu_torch.train import optim, spmd
    from ray_tpu_torch.util.collective import _collective_seconds
    from ray_tpu_torch.util.metrics import prometheus_text

    rule = {r.name: r for r in default_rules()}["train-zero-gather-stall"]
    gather = {"s": 0.0}

    def loss_fn(p, b):
        if gather["s"]:
            time.sleep(gather["s"])
            _collective_seconds().observe(gather["s"],
                                          tags={"op": "all_gather"})
        return ((p["w"] * b["x"]).sum() - 1.0) ** 2

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = build_mesh(MeshSpec(data=1), device="cpu")
        rules = PartitionRules([])
        tx = optim.sgd(0.1)
        state = spmd.init_sharded_state(
            lambda: {"w": torch.ones(8)}, tx, mesh, rules, zero_stage=3)
        step = spmd.make_train_step(loss_fn, tx, mesh=mesh, rules=rules,
                                    zero_stage=3)
        wt = Watchtower(prometheus_text, period_s=0, rules=[rule])
        batch = {"x": np.ones((2, 8), np.float32)}
        states = []
        spmd.enable_step_waterfall()
        try:
            for t, g in enumerate([0.0, 0.3, 0.3, 0.3, 0.3, 0.0, 0.0]):
                gather["s"] = g
                state, _ = step(state, batch)
                wt.sample_once(now=float(t * 15))
                active = wt.alerts_dict(include_history=False)["alerts"]
                states.append(active[0]["state"] if active else "-")
        finally:
            spmd.enable_step_waterfall(False)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
    assert states == ["-", "pending", "pending", "firing", "firing",
                      "-", "-"], states
    share = [line for line in prometheus_text().splitlines()
             if line.startswith("train_zero_gather_share ")]
    assert share and float(share[0].split()[1]) < rule.threshold


# ---------------------------------------------------------------------------
# the end-to-end gate: a live cluster, a real rule, four agreeing faces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def watch_cluster(tmp_path_factory):
    """Head (fast watchtower period, a responsive ramp rule) + one real
    nodelet, so the sampling loop exercises the genuine scrape fan-out.
    The driver process's default registry is the head's own metrics
    page, so a gauge set here is a real cluster series."""
    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.core.nodelet import Nodelet

    session_dir = str(tmp_path_factory.mktemp("wt_session"))
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
    rules = [WatchRule("queue-ramp", metric="serve_llm_queue_depth",
                       kind="rate", agg="sum", op=">", threshold=0.5,
                       window_s=6.0, for_s=0.4, severity="warning",
                       description="test ramp")]
    head = Head(watchtower_period_s=0.2, watchtower_rules=rules).start()
    nodelet = Nodelet(head.address, {"CPU": 2.0},
                      session_dir=session_dir).start()
    yield head
    # debug_dump's serve_status step auto-inits a runtime against this
    # head; release it or every later module's init() sees "called
    # twice"
    import ray_tpu_torch as ray_tpu

    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    nodelet.stop()
    head.stop()


def test_cluster_alert_fires_and_surfaces_agree(watch_cluster, capsys):
    from ray_tpu_torch.scripts import cli
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.metrics import Gauge

    head = watch_cluster
    g = Gauge("serve_llm_queue_depth", "waiting requests")
    g.set(0.0)
    # drive a deliberate queue ramp; the rule must transition
    # pending -> firing within a couple of evaluation periods
    deadline = time.monotonic() + 20.0
    v = 0.0
    fired = None
    while time.monotonic() < deadline:
        v += 1.0
        g.set(v)
        time.sleep(0.2)
        data = state.alerts(address=head.address)
        firing = [a for a in data["alerts"] if a["state"] == "firing"]
        if firing:
            fired = firing[0]
            break
    assert fired is not None, "queue ramp never fired"
    assert fired["rule"] == "queue-ramp"
    assert fired["value"] > 0.5

    # face 2: the CLI sees the same alert
    rc = cli.main(["alerts", "--address", head.address])
    out = capsys.readouterr().out
    assert rc == 0
    assert "queue-ramp" in out and "firing" in out
    rc = cli.main(["alerts", "--address", head.address, "--json"])
    cli_data = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert any(a["rule"] == "queue-ramp" and a["state"] == "firing"
               for a in cli_data["alerts"])

    # face 3: the metrics catalog gauge on the cluster page
    text = state.cluster_metrics(address=head.address)
    line = next(l for l in text.splitlines()
                if l.startswith("watchtower_alerts_firing")
                and 'severity="warning"' in l)
    assert float(line.rsplit(" ", 1)[1]) >= 1.0
    assert 'watchtower_alerts_total{rule="queue-ramp"' in text

    # face 4: transitions land as watchtower-category spans on the
    # merged timeline
    tl = state.cluster_timeline(address=head.address)
    spans = [e for e in tl if e.get("cat") == "watchtower"]
    assert any(e["name"] == "watchtower.queue-ramp" for e in spans)

    # and it RESOLVES once the condition clears (queue stops ramping)
    deadline = time.monotonic() + 20.0
    resolved = False
    while time.monotonic() < deadline:
        time.sleep(0.3)
        data = state.alerts(address=head.address)
        if not data["alerts"]:
            resolved = True
            break
    assert resolved, "alert never resolved after the ramp stopped"
    tos = [e["to"] for e in data["history"]
           if e["rule"] == "queue-ramp"]
    assert tos[:3] == ["pending", "firing", "resolved"]

    # metric history: the substrate holds a real sampled window of the
    # series that drove the rule, with bounds bookkeeping attached
    h = state.cluster_metrics_history(
        names=["serve_llm_queue_depth"], address=head.address)
    series = [s for s in h["series"]
              if s["name"] == "serve_llm_queue_depth"]
    assert series and len(series[0]["samples"]) >= 5
    ts = [t for t, _ in series[0]["samples"]]
    assert ts == sorted(ts)
    assert h["samples_total"] >= 5
    assert h["series_dropped"] >= 0


def test_debug_dump_includes_alerts_artifact(watch_cluster, tmp_path):
    from ray_tpu_torch.util import state

    out = state.debug_dump(out_dir=str(tmp_path / "dump"),
                           address=watch_cluster.address,
                           deadline_s=45)
    with open(os.path.join(out, "alerts.json")) as f:
        data = json.load(f)
    assert "alerts" in data and "history" in data and "rules" in data
    assert any(r["name"] == "queue-ramp" for r in data["rules"])
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert "alerts" in summary["artifacts"]
