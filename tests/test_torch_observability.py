"""Metrics registry, state API, CLI (reference model:
python/ray/tests/test_metrics_agent.py + util/state tests): the scenarios
of tests/test_observability.py (12) on the port's metrics export, state
API, tracing and CLI (``python -m ray_tpu_torch.scripts.cli``), on one
module-scoped cluster of the port; and `inject_labels` and
`merge_prometheus` held against the JAX package's on the same seeded
pages."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import metrics as m
from ray_tpu_torch.util import state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_registry():
    m.clear_registry()
    yield
    m.clear_registry()


def test_counter_gauge_exposition():
    c = m.Counter("reqs_total", "requests", tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2, tags={"route": "/b"})
    g = m.Gauge("queue_depth", "depth")
    g.set(7)
    text = m.prometheus_text()
    assert 'reqs_total{route="/a"} 1.0' in text
    assert 'reqs_total{route="/b"} 2.0' in text
    assert "queue_depth 7.0" in text
    assert "# TYPE reqs_total counter" in text


def test_histogram_buckets():
    h = m.Histogram("lat_s", "latency", boundaries=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = m.prometheus_text()
    assert 'lat_s_bucket{le="0.1"} 1' in text
    assert 'lat_s_bucket{le="1.0"} 2' in text
    assert 'lat_s_bucket{le="+Inf"} 3' in text
    assert "lat_s_count 3" in text


def test_metrics_http_endpoint():
    m.Counter("hits", "h").inc(3)
    port = m.serve_metrics_http(0)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        body = r.read().decode()
    assert "hits 3.0" in body


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


def test_state_api(cluster):
    @ray_tpu.remote
    class Marker:
        def ping(self):
            return "ok"

    a = Marker.options(name="state_marker").remote()
    assert ray_tpu.get(a.ping.remote(), timeout=60) == "ok"
    actors = state.list_actors()
    assert any(x["state"] == "ALIVE" for x in actors)
    nodes = state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["alive"]
    s = state.summarize()
    assert s["nodes_alive"] == 1
    assert s["actors_alive"] >= 1


def test_cli_status_and_list(cluster):
    addr = cluster.address
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "status",
         "--address", addr],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "nodes: 1 alive" in out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "list", "nodes",
         "--address", addr],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)
    assert rows and rows[0]["alive"]


def test_inject_labels_forms():
    assert m.inject_labels("hits 3.0", {"node": "abc"}) == \
        'hits{node="abc"} 3.0'
    assert m.inject_labels('lat_bucket{le="0.1"} 1', {"node": "n"}) == \
        'lat_bucket{le="0.1",node="n"} 1'
    # two tags, sorted for stable output
    assert m.inject_labels("x 1", {"proc": "w", "node": "n"}) == \
        'x{node="n",proc="w"} 1'
    # a key the series already carries is NOT duplicated (duplicate
    # label names are invalid exposition format)
    assert m.inject_labels('x{proc="mine"} 1', {"proc": "w", "node": "n"}) \
        == 'x{proc="mine",node="n"} 1'


def test_merge_prometheus_dedupes_meta_and_tags_pages():
    page = ("# HELP hits h\n# TYPE hits counter\nhits 1.0\n")
    merged = m.merge_prometheus([({"node": "a"}, page),
                                 ({"node": "b"}, page)])
    assert merged.count("# TYPE hits counter") == 1
    assert 'hits{node="a"} 1.0' in merged
    assert 'hits{node="b"} 1.0' in merged


def test_merge_prometheus_groups_families_contiguously():
    """Standard parsers demote samples separated from their TYPE header
    to untyped: a family on 2+ pages must merge into ONE header with
    all samples directly under it (histograms especially — _bucket/_sum/
    _count lines carry suffixed names)."""
    h = m.Histogram("mp_lat", "l", boundaries=(1.0,))
    h.observe(0.5)
    c = m.Counter("mp_hits", "h")
    c.inc()
    page = m.prometheus_text()
    merged = m.merge_prometheus([({"node": "a"}, page),
                                 ({"node": "b"}, page)])
    lines = merged.splitlines()
    start = lines.index("# TYPE mp_lat histogram")
    block = lines[start + 1:start + 7]  # 3 sample lines x 2 pages
    assert all(l.startswith("mp_lat") for l in block), block
    assert sum(1 for l in lines if l.startswith("# TYPE mp_lat")) == 1
    # the counter family survives as its own contiguous block too
    assert 'mp_hits{node="a"} 1.0' in merged
    assert 'mp_hits{node="b"} 1.0' in merged


def test_nested_span_api_links_and_epoch_anchor(cluster):
    """util.tracing.span: nesting produces parent-linked spans sharing
    one trace_id, with epoch-anchored (wall-clock-comparable) ts."""
    import time as _t

    from ray_tpu_torch.util import tracing

    with tracing.span("t_outer") as t_o:
        with tracing.span("t_inner") as t_i:
            pass
    assert t_i["trace_id"] == t_o["trace_id"]
    assert t_i["parent_id"] == t_o["span_id"]
    events = {e["name"]: e for e in ray_tpu.timeline()
              if e.get("ph") == "X"}
    assert events["t_inner"]["args"]["parent_id"] == \
        events["t_outer"]["args"]["span_id"]
    # the epoch-anchoring contract (the old monotonic-only ts bug):
    # span timestamps must be comparable to wall-clock time
    assert abs(events["t_outer"]["ts"] - _t.time() * 1e6) < 300e6


def test_span_context_threads_into_tasks(cluster):
    from ray_tpu_torch.util import tracing

    @ray_tpu.remote(num_cpus=0.1)
    def probe():
        from ray_tpu_torch.util import tracing as _tr

        return _tr.current_trace()

    with tracing.span("t_root") as root:
        child = ray_tpu.get(probe.remote(), timeout=60)
    assert child["trace_id"] == root["trace_id"]
    assert child["parent_id"] == root["span_id"]


def test_histogram_recreation_shares_state():
    h1 = m.Histogram("shared_lat", "l", boundaries=(1.0,))
    h1.observe(0.5)
    h2 = m.Histogram("shared_lat", "l", boundaries=(1.0,))
    h2.observe(0.7)  # must land in the registered instance's buckets
    text = m.prometheus_text()
    assert "shared_lat_count 2" in text


def test_list_tasks_state_api(cluster):
    @ray_tpu.remote(num_cpus=0.1)
    def traced(x):
        if x == 3:
            raise ValueError("boom")
        return x

    refs = [traced.remote(i) for i in range(4)]
    for i, r in enumerate(refs):
        try:
            ray_tpu.get(r, timeout=60)
        except Exception:
            assert i == 3
    import time as _t

    deadline = _t.monotonic() + 20
    while _t.monotonic() < deadline:
        tasks = state.list_tasks()
        finished = [t for t in tasks if t["name"] == "traced"]
        if len(finished) >= 4:
            break
        _t.sleep(0.2)
    states = sorted(t["state"] for t in finished)
    assert states.count("FINISHED") == 3
    assert states.count("FAILED") == 1
    assert all(t["duration_ms"] >= 0 for t in finished)


def _seeded_pages(seed: int, n_pages: int = 3) -> list[tuple[dict, str]]:
    """Exposition pages made from a seed: counters, gauges and
    histograms with and without labels, some families on every page,
    some on one, a page with a series that already carries a tag."""
    rng = np.random.RandomState(seed)
    pages = []
    for p in range(n_pages):
        lines = []
        for f in range(int(rng.randint(3, 7))):
            if p and rng.rand() < 0.3:
                continue  # this family is absent from this page
            kind = ("counter", "gauge", "histogram")[f % 3]
            name = f"fam{f}_{kind}"
            lines += [f"# HELP {name} family {f}", f"# TYPE {name} {kind}"]
            for s in range(int(rng.randint(1, 4))):
                lab = (f'{{route="/r{s}"}}' if rng.rand() < 0.5 else
                       f'{{node="mine",k="{s}"}}' if rng.rand() < 0.3
                       else "")
                val = float(np.round(rng.rand() * 100, 3))
                if kind != "histogram":
                    lines.append(f"{name}{lab} {val}")
                    continue
                for le in ("0.1", "1.0", "+Inf"):
                    inner = (lab[1:-1] + "," if lab else "") + f'le="{le}"'
                    lines.append(f"{name}_bucket{{{inner}}} {s + 1}")
                lines += [f"{name}_sum{lab} {val}", f"{name}_count{lab} 3"]
        if rng.rand() < 0.5:
            lines.append(f"headerless_{p} {p}")
        pages.append(({"node": f"n{p}", "proc": f"w{p}"}
                      if rng.rand() < 0.5 else {"node": f"n{p}"},
                      "\n".join(lines) + "\n"))
    return pages


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_and_inject_match_jax(seed):
    """The export half is the JAX package's: the same seeded pages merge
    to the same text, and every sample line gets the same labels."""
    from ray_tpu.util import metrics as jm

    pages = _seeded_pages(seed)
    assert m.merge_prometheus(pages) == jm.merge_prometheus(pages)
    for tags, text in pages:
        for line in text.splitlines():
            if line and not line.startswith("#"):
                assert m.inject_labels(line, tags) == \
                    jm.inject_labels(line, tags), line
