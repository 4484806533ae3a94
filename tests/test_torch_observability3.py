"""Cluster-wide tracing + metrics plane: merged timeline with
epoch-aligned cross-node spans, trace_id correlation across a
driver→actor→task chain, and the head's cluster /metrics aggregation
(reference model: `ray timeline` over the task-event pipeline +
the dashboard's Prometheus surface): the scenarios of
tests/test_observability3.py (5) on the port's two-node cluster. One
change to a scenario: the port compiles nothing, so the train-metrics
scenario holds the step histogram's series (``train_step_seconds_count``)
tagged by both nodes where JAX holds its compile-miss counter's."""

import os
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import state, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster2():
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4,
                                "resources": {"n1": 2.0}})
    c.add_node(num_cpus=4, resources={"n2": 2.0})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


def _timeline_spans(want_names, timeout=25.0):
    """Poll the merged timeline until every wanted span name arrived
    (worker span flushes are periodic)."""
    deadline = time.monotonic() + timeout
    while True:
        tl = ray_tpu.timeline()
        spans = [e for e in tl if e.get("ph") == "X"]
        names = {e["name"] for e in spans}
        if set(want_names) <= names or time.monotonic() > deadline:
            return tl, spans


def test_merged_timeline_cross_node_epoch_aligned(cluster2):
    @ray_tpu.remote(num_cpus=0.1, resources={"n1": 0.1})
    def t3_on_n1():
        with tracing.span("t3-inner-n1"):
            time.sleep(0.01)
        return ray_tpu.get_runtime_context().node_id.hex()

    @ray_tpu.remote(num_cpus=0.1, resources={"n2": 0.1})
    def t3_on_n2():
        return ray_tpu.get_runtime_context().node_id.hex()

    t0_us = time.time() * 1e6
    n1 = ray_tpu.get(t3_on_n1.remote(), timeout=60)
    n2 = ray_tpu.get(t3_on_n2.remote(), timeout=60)
    assert n1 != n2

    tl, spans = _timeline_spans({"t3_on_n1", "t3_on_n2", "t3-inner-n1"})
    by_name = {e["name"]: e for e in spans}
    a, b = by_name["t3_on_n1"], by_name["t3_on_n2"]
    # pid = node: the two task spans render as different processes
    assert a["pid"] != b["pid"]
    # both nodes named in the process metadata
    proc_names = {e["args"]["name"] for e in tl
                  if e.get("ph") == "M" and e["name"] == "process_name"}
    assert any(n1[:16] in p for p in proc_names), proc_names
    assert any(n2[:16] in p for p in proc_names), proc_names
    # epoch anchoring: ts is wall-clock-comparable across processes (a
    # monotonic-only ts would sit at machine-uptime scale, far away)
    now_us = time.time() * 1e6
    for ev in (a, b, by_name["t3-inner-n1"]):
        assert t0_us - 120e6 < ev["ts"] < now_us + 120e6, ev
    # cross-process ordering: n1 ran (and was awaited) before n2 was
    # submitted, so the epoch-aligned timestamps must order them
    assert a["ts"] < b["ts"] + 1e3  # 1ms NTP-class slack (same host: 0)
    # the nested user span sits inside its task span's window
    inner = by_name["t3-inner-n1"]
    assert a["ts"] - 1e3 <= inner["ts"] <= a["ts"] + a["dur"] + 1e3


def test_trace_id_correlates_driver_actor_task_chain(cluster2):
    @ray_tpu.remote(num_cpus=0.1, resources={"n1": 0.1})
    def t3_leaf():
        with tracing.span("t3-leaf-work"):
            pass
        return tracing.current_trace()["trace_id"]

    @ray_tpu.remote(num_cpus=0.1, resources={"n2": 0.1})
    class T3Chain:
        def call(self):
            return ray_tpu.get(t3_leaf.remote(), timeout=60)

    with tracing.span("t3-root") as root:
        a = T3Chain.remote()
        leaf_trace_id = ray_tpu.get(a.call.remote(), timeout=60)
    # context propagated driver -> actor (node2) -> task (node1)
    assert leaf_trace_id == root["trace_id"]

    tl, spans = _timeline_spans({"t3-root", "T3Chain.call",
                                 "t3-leaf-work"})
    chain = [e for e in spans
             if e.get("args", {}).get("trace_id") == root["trace_id"]]
    names = {e["name"] for e in chain}
    assert {"t3-root", "T3Chain.call", "t3-leaf-work"} <= names, names
    # the one trace crosses >= 2 processes of the merged timeline
    assert len({e["pid"] for e in chain}) >= 2, chain
    # and parent links chain: the actor span's parent is the root span
    call = next(e for e in chain if e["name"] == "T3Chain.call")
    assert call["args"]["parent_id"] == root["span_id"]


def test_cluster_metrics_aggregates_train_metrics_by_node(cluster2):
    def _t3_train_steps():
        """Tiny train loop through make_train_step — populates the
        train_step_seconds histogram in THIS worker process's
        registry."""
        import torch

        from ray_tpu_torch.train import optim
        from ray_tpu_torch.train.spmd import TrainState, make_train_step

        tx = optim.sgd(0.1)
        state0 = TrainState.create({"w": torch.zeros(4)}, tx)

        def loss_fn(params, batch):
            return torch.sum((params["w"] - batch["x"]) ** 2)

        step = make_train_step(loss_fn, tx)
        s = state0
        for _ in range(3):
            s, m = step(s, {"x": torch.ones(4)})
        return float(m["loss"])

    t3_train_n1 = ray_tpu.remote(num_cpus=0.5,
                                 resources={"n1": 0.1})(_t3_train_steps)
    t3_train_n2 = ray_tpu.remote(num_cpus=0.5,
                                 resources={"n2": 0.1})(_t3_train_steps)
    ray_tpu.get([t3_train_n1.remote(), t3_train_n2.remote()], timeout=120)

    text = state.cluster_metrics()
    # acceptance: train step-time histogram on the head page, tagged by
    # node — from BOTH nodes' workers
    assert "# TYPE train_step_seconds histogram" in text
    miss_nodes = set()
    for line in text.splitlines():
        if line.startswith("train_step_seconds_count{"):
            tags = line.split("{", 1)[1].split("}", 1)[0]
            node = [t for t in tags.split(",") if t.startswith('node="')]
            assert node, line
            miss_nodes.add(node[0])
    assert len(miss_nodes) >= 2, text
    # object-plane metrics ride the same page
    assert "object_store_bytes_allocated" in text


def test_head_metrics_http_endpoint(cluster2):
    port = cluster2.head.start_metrics_http(0)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=15) as r:
        body = r.read().decode()
    assert 'node="' in body
    assert "object_store_bytes_allocated" in body


def test_cli_metrics_and_timeline(cluster2, tmp_path):
    import json
    import subprocess

    addr = cluster2.address
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "metrics",
         "--address", addr],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr
    assert 'node="' in out.stdout

    trace_file = str(tmp_path / "tl.json")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "timeline",
         "--address", addr, "-o", trace_file],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr
    with open(trace_file) as f:
        events = json.load(f)
    assert isinstance(events, list) and events
