"""Auxiliary runtime surfaces: log streaming, trace propagation,
fixed-point resources, the typed GCS client, long-poll pubsub and the
object listings.

Reference parity: python/ray/_private/log_monitor.py:103 (log
streaming), ray/util/tracing/tracing_helper.py:34 (span propagation),
src/ray/common/scheduling/fixed_point.h (resource arithmetic),
train/v2/_internal/execution/scaling_policy/scaling_policy.py:26
(continuous scaling decisions).

The scenarios of tests/test_observability2.py (6) on one module-scoped
cluster of the port.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


def test_log_streaming(cluster):
    """Worker stdout is tailable through the state API / nodelet
    (the `ray logs` + dashboard log-monitor capability)."""
    from ray_tpu_torch.util import state

    @ray_tpu.remote(num_cpus=1)
    def noisy():
        print("hello-from-worker-log", flush=True)
        return 1

    assert ray_tpu.get(noisy.remote(), timeout=60) == 1
    node_id = ray_tpu.nodes()[0]["NodeID"]
    logs = state.list_logs(node_id)
    worker_logs = [l for l in logs if l["file"].startswith("worker-")]
    assert worker_logs, logs
    found = False
    ends = {}
    for lg in worker_logs:
        text, end = state.tail_log(node_id, lg["file"])
        ends[lg["file"]] = end
        if "hello-from-worker-log" in text:
            found = True
    assert found, "worker stdout not streamed"
    # incremental follow: offset at THIS file's end returns empty
    first = worker_logs[0]["file"]
    text2, _ = state.tail_log(node_id, first, offset=ends[first])
    assert text2 == ""


def test_trace_propagates_through_nested_tasks(cluster):
    """A task submitting a nested task carries the same trace_id; span
    parent links chain (OTel-style propagation)."""

    @ray_tpu.remote(num_cpus=0.1)
    def inner():
        from ray_tpu_torch.core.api import _global_runtime

        return _global_runtime()._ctx.trace

    @ray_tpu.remote(num_cpus=0.1)
    def outer():
        from ray_tpu_torch.core.api import _global_runtime

        my = _global_runtime()._ctx.trace
        child = ray_tpu.get(inner.remote(), timeout=60)
        return my, child

    my, child = ray_tpu.get(outer.remote(), timeout=60)
    assert my["trace_id"] == child["trace_id"]
    assert child["parent_id"] == my["span_id"]
    assert my["span_id"] != child["span_id"]


def test_fixed_point_resources_no_drift(cluster):
    """1000 acquire/release cycles of 0.1 CPU leave the ledger exactly
    whole (fixed_point.h semantics)."""
    from ray_tpu_torch.core.nodelet import _fpq

    x = 4.0
    for _ in range(1000):
        x = _fpq(x - 0.1)
        x = _fpq(x + 0.1)
    assert x == 4.0
    # plain float arithmetic drifts; the quantized ledger must not
    y = 4.0
    for _ in range(1000):
        y = y - 0.1 + 0.1
    assert _fpq(y) == 4.0


def test_gcs_client_typed_accessors(cluster):
    """Typed accessor suite over the head (reference:
    src/ray/gcs/gcs_client/accessor.h:43-583)."""
    from ray_tpu_torch.core.gcs_client import GcsClient

    gcs = GcsClient()
    nodes = gcs.get_all_node_info()
    assert nodes and nodes[0]["alive"] and "CPU" in nodes[0]["resources"]
    assert gcs.get_node_info(nodes[0]["node_id"])["address"]
    assert gcs.get_cluster_resources()["CPU"] >= 4.0

    assert gcs.internal_kv_put("k1", b"v1") is True
    assert gcs.internal_kv_put("k1", b"v2", overwrite=False) is False
    assert gcs.internal_kv_get("k1") == b"v1"
    assert "k1" in gcs.internal_kv_keys("k")
    assert gcs.internal_kv_del("k1") is True
    assert gcs.internal_kv_get("k1") is None

    @ray_tpu.remote(num_cpus=0)
    class A:
        def ping(self):
            return 1

    a = A.options(name="gcs_probe").remote()
    ray_tpu.get(a.ping.remote())
    actors = gcs.get_all_actor_info()
    assert any(x.get("name") == "gcs_probe" for x in actors)
    named = gcs.get_named_actor_info("gcs_probe")
    assert named.get("found")
    assert gcs.get_task_events(limit=10) is not None
    ray_tpu.kill(a)


def test_pubsub_long_poll_subscriber(cluster):
    """Long-poll subscription buffers messages while the subscriber is
    away (reference: per-subscriber mailboxes, pubsub/publisher.h:297)."""
    import threading

    from ray_tpu_torch.core.api import _global_runtime

    rt = _global_runtime()
    head = rt.head_address
    sub = {"subscriber_id": "test-sub-1", "topics": ["custom"],
           "mode": "poll"}
    assert rt.client.call(head, "subscribe", sub, timeout=10)["subscribed"]
    # publish while NOT polling: messages buffer instead of dropping
    for i in range(3):
        rt.client.send_oneway(head, "publish",
                              {"topic": "custom", "data": {"i": i}})
    deadline = time.monotonic() + 10
    msgs = []
    while time.monotonic() < deadline and len(msgs) < 3:
        r = rt.client.call(head, "poll_messages",
                           {"subscriber_id": "test-sub-1", "timeout": 1.0},
                           timeout=30)
        msgs.extend(r["messages"])
    assert [m["data"]["i"] for m in msgs] == [0, 1, 2]

    # long-poll blocks until a message arrives
    got = {}

    def poll():
        got.update(rt.client.call(
            head, "poll_messages",
            {"subscriber_id": "test-sub-1", "timeout": 8.0}, timeout=30))

    t = threading.Thread(target=poll)
    t.start()
    time.sleep(0.3)
    rt.client.send_oneway(head, "publish",
                          {"topic": "custom", "data": {"i": 99}})
    t.join(timeout=10)
    assert [m["data"]["i"] for m in got["messages"]] == [99]
    rt.client.call(head, "unsubscribe",
                   {"subscriber_id": "test-sub-1"}, timeout=10)


def test_state_list_objects_and_memory_summary(cluster):
    """state.list_objects covers worker-owned objects too (a borrower
    chain: driver owns the produced ref; the worker's own table shows
    during execution) and memory_summary aggregates stores."""
    import numpy as np

    from ray_tpu_torch.util import state

    @ray_tpu.remote(num_cpus=0.1)
    def produce():
        return np.ones(512 * 1024, np.uint8)

    refs = [produce.remote() for _ in range(3)]
    ray_tpu.get(refs, timeout=60)
    objs = state.list_objects()
    ids = {o["object_id"] for o in objs}
    assert all(r.id.hex() in ids for r in refs)
    s = state.memory_summary()
    assert s["objects_total"] >= 3
    assert s["objects_bytes"] >= 3 * 512 * 1024
    assert any(n["store_bytes_allocated"] > 0 for n in s["nodes"])
    report = state.memory_report()
    assert "object store per node" in report and "owned objects" in report
