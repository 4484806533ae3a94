"""Critical-path analysis (``ray_tpu_torch.util.critpath``): the
critpath scenarios of tests/test_flight_recorder.py on the port, each
held against the JAX package's `critical_path`/`aggregate` on the same
spans; both packages on seeded span lists; and `state.critical_path`
and the CLI's `critpath` over the head's span buffer on one port
cluster."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from ray_tpu.util import critpath as jax_cp
from ray_tpu_torch.util import critpath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000_000_000.0


def _span(name, ts_us, dur_us, trace="tr"):
    return {"name": name, "cat": "dag", "ph": "X", "ts": ts_us,
            "dur": dur_us, "args": {"trace_id": trace}}


def _both(fn_name, *args, **kw):
    """The port's result, after asserting it equals JAX's."""
    ours = getattr(critpath, fn_name)(*args, **kw)
    theirs = getattr(jax_cp, fn_name)(*args, **kw)
    assert ours == theirs
    return ours


def test_critpath_chain_and_slack():
    spans = [_span("a", T0, 10_000), _span("b", T0 + 10_020, 50_000),
             _span("c", T0 + 61_000, 10_000)]
    r = _both("critical_path", spans, "tr")
    assert [c["name"] for c in r["chain"]] == ["a", "b", "c"]
    assert r["slowest"] == "b"
    # slack: a→b handoff is sub-eps (contiguous), b→c has ~1ms idle
    assert r["chain"][1]["slack_ms"] == pytest.approx(0.02, abs=0.05)
    assert r["chain"][2]["slack_ms"] == pytest.approx(0.98, abs=0.1)
    assert r["coverage"] > 0.95


def test_critpath_coverage_does_not_double_count_overlap():
    """A covering parent span overlapping its children must not push
    coverage past 1.0 — covered time is a union of intervals."""
    spans = [_span("parent", T0, 100_000),
             _span("child1", T0 + 1_000, 40_000),
             _span("child2", T0 + 50_000, 45_000)]
    r = _both("critical_path", spans, "tr")
    assert r["coverage"] <= 1.0
    assert r["e2e_ms"] == pytest.approx(100.0, abs=0.01)


def test_critpath_aggregate_across_traces():
    spans = []
    for i, tr in enumerate(("t1", "t2", "t3")):
        base = T0 + i * 1_000_000
        spans += [_span("load", base, 10_000, tr),
                  _span("compute", base + 10_050, 80_000, tr)]
    r = _both("aggregate", spans)
    assert r["traces"] == 3
    by_name = {e["name"]: e for e in r["entries"]}
    assert by_name["compute"]["count"] == 3
    assert by_name["compute"]["total_ms"] > by_name["load"]["total_ms"]
    assert r["entries"][0]["name"] == "compute"  # sorted by total


def test_critpath_empty_trace():
    r = _both("critical_path", [], "nope")
    assert r["chain"] == [] and r["coverage"] == 0.0


def _seeded_spans(seed: int) -> list[dict]:
    """Span dumps made from a seed: several traces of sequential,
    overlapping and covering spans, with the entries the analysis must
    skip (begin/instant events, zero durations, spans without a trace),
    node/proc tags on some, and shuffled order."""
    rng = np.random.default_rng(seed)
    spans = []
    for t in range(int(rng.integers(2, 6))):
        trace = f"{seed:02d}{t:030x}"
        ts = T0 + t * 5e6
        for i in range(int(rng.integers(1, 9))):
            dur = float(rng.integers(1, 200_000))
            s = _span(f"s{int(rng.integers(0, 5))}", ts, dur, trace)
            if rng.random() < 0.5:
                s["node"] = f"n{int(rng.integers(0, 3))}"
                s["proc"] = f"w{int(rng.integers(0, 4))}"
            spans.append(s)
            # the next span starts after, inside, or within eps of this one
            ts += dur * float(rng.choice([1.0, 0.5, 1.3])) \
                + float(rng.choice([0.0, 20.0, 3_000.0]))
        if rng.random() < 0.5:  # a covering parent
            lo = min(s["ts"] for s in spans if
                     s["args"]["trace_id"] == trace)
            spans.append(_span("parent", lo - 100.0, ts - lo + 500.0, trace))
        spans.append({**_span("begin", ts, 0.0, trace), "ph": "B"})
        spans.append(_span("zero", ts, 0.0, trace))
    spans.append({"name": "untraced", "ph": "X", "ts": T0, "dur": 5.0})
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_critpath_matches_jax_on_seeded_spans(seed):
    spans = _seeded_spans(seed)
    traces = sorted({s["args"]["trace_id"] for s in spans if "args" in s})
    for tr in traces + [None, "absent"]:
        r = _both("critical_path", spans, tr)
        if tr in traces:
            assert r["chain"] and r["coverage"] <= 1.0
    for min_spans in (1, 2, 3):
        r = _both("aggregate", spans, min_spans=min_spans)
        assert r["traces"] <= len(traces)
    assert _both("aggregate", spans, min_spans=1)["traces"] == len(traces)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


def test_state_and_cli_critical_path_over_worker_spans(cluster):
    """A worker lays three spans of one trace (the middle one slow);
    once its span flush reaches the head, `state.critical_path` names
    them in order with the slow one slowest, equal to the pure
    function on the head's own span dump, and the CLI prints the same
    chain."""
    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.core.rpc import RpcClient
    from ray_tpu_torch.util import state

    trace_id = "cp" + "0" * 28 + "01"

    @ray_tpu.remote(num_cpus=0.1)
    def lay(trace_id):
        import time as _t

        from ray_tpu_torch.util import tracing as _tr

        tr = {"trace_id": trace_id, "span_id": "1" * 16,
              "parent_id": None}
        t = _t.monotonic()
        for name, d in (("cp_load", 0.01), ("cp_slow", 0.05),
                        ("cp_store", 0.01)):
            _tr.record_interval(name, t, t + d, trace=tr)
            t += d + 0.002
        return True

    assert ray_tpu.get(lay.remote(trace_id), timeout=60)
    deadline = time.monotonic() + 20
    while True:  # the worker's span flush rides its event loop
        spans = RpcClient.shared().call(cluster.address, "dump_timeline",
                                        {}, timeout=30)["spans"]
        ours = [s for s in spans
                if (s.get("args") or {}).get("trace_id") == trace_id]
        if len(ours) == 3 or time.monotonic() > deadline:
            break
        time.sleep(0.3)
    assert len(ours) == 3, ours
    r = state.critical_path(trace_id=trace_id)
    assert [c["name"] for c in r["chain"]] == ["cp_load", "cp_slow",
                                               "cp_store"]
    assert r["slowest"] == "cp_slow"
    assert r["chain"][2]["slack_ms"] == pytest.approx(2.0, abs=1.5)
    assert r == jax_cp.critical_path(ours, trace_id)
    agg = state.critical_path()
    assert "cp_slow" in {e["name"] for e in agg["entries"]}

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "critpath",
         "--address", cluster.address, "--trace-id", trace_id, "--json"],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert [c["name"] for c in json.loads(out.stdout)["chain"]] == [
        "cp_load", "cp_slow", "cp_store"]
