"""The port's RPC (ray_tpu_torch.core.rpc: TCP and a selector thread in
place of ZeroMQ) through every scenario of tests/test_rpc_batching.py —
oneway coalescing, the submit Batcher, the cluster-level coalesced
frames, the batch-size histogram, handler event stats — plus what the
transport itself must do: reconnect to a peer that restarts on its
address, time a call to a dead peer out at the caller's deadline, and
the chaos environment's drop and delay budgets.

The JAX tests read the metrics through ``prometheus_text``, which the
port does not have yet; here the same series are read from the port's
metrics registry (each metric's exposition lines)."""

import threading
import time

import pytest

from ray_tpu_torch.core import rpc as rpc_mod
from ray_tpu_torch.core.rpc import (
    Batcher,
    PeerUnavailableError,
    RpcClient,
    RpcServer,
)


def _page() -> str:
    """This process's metric series, one exposition line each."""
    from ray_tpu_torch.util import metrics

    return "\n".join(line for m in metrics._registry.collect()
                     for line in m.expose())


def test_oneway_batching_delivers_all_with_fewer_sends():
    server = RpcServer(name="batch-test").start()
    got = []
    server.register("inc", lambda msg, frames: got.append(msg["i"]),
                    oneway=True)
    client = RpcClient()  # private instance: do not disturb the shared one
    try:
        peer = client._peer(server.address)
        sends = []
        orig = peer.send

        def counting_send(parts):
            sends.append(len(parts))
            return orig(parts)

        peer.send = counting_send
        for i in range(100):
            client.send_oneway(server.address, "inc", {"i": i})
        deadline = time.time() + 10
        while time.time() < deadline and len(got) < 100:
            time.sleep(0.01)
        assert sorted(got) == list(range(100))
        # coalesced: far fewer messages than oneways
        assert 0 < len(sends) < 50, len(sends)
    finally:
        client.close()
        server.stop()


def test_oneway_flushed_before_call():
    """Wire ordering: a oneway buffered before a call to the same peer
    leaves first."""
    server = RpcServer(name="order-test").start()
    order = []
    server.register("mark", lambda msg, frames: order.append("oneway"),
                    oneway=True)

    def ping(msg, frames):
        # the oneway was dispatched to the pool before this call; give
        # its handler a moment to run
        t0 = time.time()
        while "oneway" not in order and time.time() - t0 < 5:
            time.sleep(0.005)
        order.append("call")
        return {}

    server.register("ping", ping)
    client = RpcClient()
    try:
        client.send_oneway(server.address, "mark", {})
        client.call(server.address, "ping", {}, timeout=30)
        assert order == ["oneway", "call"]
    finally:
        client.close()
        server.stop()


def test_large_or_framed_oneways_bypass_batching():
    server = RpcServer(name="big-test").start()
    got = []
    server.register("blob", lambda msg, frames: got.append(
        (len(msg.get("data", b"")), len(frames))), oneway=True)
    client = RpcClient()
    try:
        client.send_oneway(server.address, "blob",
                           {"data": b"x" * (64 * 1024)})
        client.send_oneway(server.address, "blob", {}, frames=[b"frame"])
        deadline = time.time() + 10
        while time.time() < deadline and len(got) < 2:
            time.sleep(0.01)
        assert sorted(got) == [(0, 1), (64 * 1024, 0)]
    finally:
        client.close()
        server.stop()


def test_batcher_size_triggered_inline_flush(monkeypatch):
    """A buffer reaching SUBMIT_BATCH_MAX flushes on the appending
    thread — a tight submit loop never waits for the window."""
    monkeypatch.setenv("RAY_TPU_SUBMIT_BATCH_MAX", "8")
    flushed = []
    b = Batcher("t", lambda key, entries: flushed.append(
        (key, list(entries))))
    for i in range(8):
        b.append("k", i)
    assert flushed == [("k", list(range(8)))]
    assert b.pending_count() == 0
    b.close()


def test_batcher_window_flushes_stragglers(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SUBMIT_BATCH_MAX", "1000")
    flushed = []
    b = Batcher("t", lambda key, entries: flushed.append(list(entries)))
    b.append("k", 1)
    b.append("k", 2)
    deadline = time.time() + 5
    while time.time() < deadline and not flushed:
        time.sleep(0.005)
    assert flushed == [[1, 2]]  # idle window swept the partial batch
    b.close()


def test_batcher_force_flush_and_per_key_order(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SUBMIT_BATCH_MAX", "1000")
    flushed = []
    b = Batcher("t", lambda key, entries: flushed.append(
        (key, list(entries))))
    for i in range(5):
        b.append("a", i)
    b.append("b", 99)
    b.flush("a")  # only a's buffer leaves
    assert flushed == [("a", [0, 1, 2, 3, 4])]
    b.flush()
    assert flushed[1] == ("b", [99])
    b.close()


def test_batcher_window_zero_sends_immediately(monkeypatch):
    """SUBMIT_BATCH_WINDOW_MS=0 = send each immediately (the config
    flag's documented contract, same as the oneway batcher's)."""
    monkeypatch.setenv("RAY_TPU_SUBMIT_BATCH_WINDOW_MS", "0")
    flushed = []
    b = Batcher("t", lambda key, entries: flushed.append(list(entries)))
    b.append("k", 1)
    b.append("k", 2)
    assert flushed == [[1], [2]]  # no buffering, no sweeper involved
    b.close()


def test_batcher_flush_fn_error_never_wedges():
    calls = []

    def boom(key, entries):
        calls.append(list(entries))
        raise RuntimeError("flush boom")

    b = Batcher("t", boom)
    b.append("k", 1)
    b.flush()
    b.append("k", 2)
    b.flush()
    assert calls == [[1], [2]]  # second flush still ran
    assert b.pending_count() == 0
    b.close()


# ------------------------------------------------- cluster-level batching


@pytest.fixture(scope="module")
def batch_cluster():
    import os

    import ray_tpu_torch

    os.environ["RAY_TPU_PRESTART_WORKERS"] = "2"
    try:
        ray_tpu_torch.init(num_cpus=4)
    finally:
        os.environ.pop("RAY_TPU_PRESTART_WORKERS", None)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_actor_call_burst_coalesces_and_stays_ordered(batch_cluster):
    """A burst of pipelined actor calls rides actor_calls frames (the
    driver's coalesce counter moves) while per-actor submission order
    is preserved on a serial actor, and the return path delivers every
    result (task_done_batch dispatches on the driver's own server)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.core import cluster_runtime as cr
    from ray_tpu_torch.core.api import _global_runtime

    @ray.remote(num_cpus=0)
    class Seq:
        def __init__(self):
            self.log = []

        def mark(self, i):
            self.log.append(i)
            return i

        def read(self):
            return list(self.log)

    # earlier suites may clear the registry: reset the lazy counter so
    # it re-registers into the current registry
    cr._coalesced_counter = None
    rt = _global_runtime()
    a = Seq.remote()
    ray.get(a.read.remote(), timeout=60)

    def counts():
        out = {}
        for line in _page().splitlines():
            if line.startswith("core_submit_coalesced_total"):
                name, v = line.rsplit(" ", 1)
                out[name] = float(v)
        return out

    before = counts()
    n = 400
    refs = [a.mark.remote(i) for i in range(n)]
    assert ray.get(refs, timeout=120) == list(range(n))
    # order preserved end to end through the batched frames
    assert ray.get(a.read.remote(), timeout=60) == list(range(n))
    after = counts()
    key = 'core_submit_coalesced_total{kind="actor_call"}'
    assert after.get(key, 0) - before.get(key, 0) > 0, (before, after)
    # the return path coalesced too: the driver's server dispatched
    # task_done_batch frames, far fewer than one per call
    stats = rt.server.event_stats()
    assert stats.get("task_done_batch", {}).get("count", 0) > 0
    ray.kill(a)


def test_plain_task_burst_rides_schedule_tasks_frames(batch_cluster):
    """Tasks off the lease path (here: soft label selector) coalesce
    into schedule_tasks frames on the nodelet — far fewer scheduling
    dispatches than tasks — and every result lands."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.core.api import _global_runtime
    from ray_tpu_torch.util.scheduling_strategies import SOFT_AFFINITY_LABEL

    rt = _global_runtime()
    nodelet = rt._booted[1]

    @ray.remote(num_cpus=0.1,
                label_selector={"no-such-label": "x",
                                SOFT_AFFINITY_LABEL: "1"})
    def double(x):
        return x * 2

    assert ray.get(double.remote(1), timeout=60) == 2  # warm path
    before = nodelet.server.event_stats()
    n = 100
    refs = [double.remote(i) for i in range(n)]
    assert ray.get(refs, timeout=120) == [i * 2 for i in range(n)]
    after = nodelet.server.event_stats()
    batched = after.get("schedule_tasks", {}).get("count", 0) - \
        before.get("schedule_tasks", {}).get("count", 0)
    singles = after.get("schedule_task", {}).get("count", 0) - \
        before.get("schedule_task", {}).get("count", 0)
    assert batched >= 1
    # the burst rode batch frames, not per-task round trips
    assert batched + singles < n / 2, (batched, singles)


def test_oneway_batch_size_histogram_observes():
    # earlier suites may clear the registry: reset the lazy histogram so
    # it re-registers into the current registry
    rpc_mod._batch_size_hist = None
    server = RpcServer(name="hist-test").start()
    server.register("tick", lambda msg, frames: None, oneway=True)
    client = RpcClient()
    try:
        for i in range(50):
            client.send_oneway(server.address, "tick", {"i": i})
        client.flush_oneways()
        text = _page()
        assert "rpc_oneway_batch_size_count" in text
    finally:
        client.close()
        server.stop()


def test_event_stats_track_handlers_and_lag():
    """Reference: common/event_stats.h — per-handler duration + queue
    lag visible on the server."""
    server = RpcServer(name="stats-test").start()
    server.register("work", lambda msg, frames: time.sleep(0.02) or {})
    client = RpcClient()
    try:
        for _ in range(3):
            client.call(server.address, "work", {}, timeout=30)
        stats = server.event_stats()
        assert stats["work"]["count"] == 3
        assert stats["work"]["total_ms"] >= 3 * 20
        assert stats["work"]["max_ms"] >= 20
        assert stats["work"]["max_lag_ms"] >= 0
    finally:
        client.close()
        server.stop()


# ------------------------------------------------------------- transport


class _FixedPortServer(RpcServer):
    """An RpcServer bound to a given port (a peer restarting on its
    address)."""

    port = 0

    @classmethod
    def _listen(cls, host, port=0):
        return RpcServer._listen(host, cls.port)


def test_peer_restart_on_its_address_reconnects():
    """A call queued while the peer is down goes out when a server comes
    back on the same address, as a DEALER reconnects; the client's
    frames and large payloads survive the new connection."""
    first = RpcServer(name="restart-a").start()
    first.register("who", lambda msg, frames: "first")
    client = RpcClient()
    try:
        assert client.call(first.address, "who", {}, timeout=10) == "first"
        _FixedPortServer.port = int(first.address.rsplit(":", 1)[1])
        first.stop()
        with pytest.raises(PeerUnavailableError, match="timed out"):
            client.call(first.address, "who", {}, timeout=0.5)
        pending = client.call_async(first.address, "who", {"n": 1},
                                    frames=[b"y" * (8 << 20)])
        time.sleep(0.3)  # queued behind the refused reconnects
        second = _FixedPortServer(name="restart-b").start()
        second.register("who", lambda msg, frames: ("second",
                                                    len(frames[0])))
        try:
            assert second.address == first.address
            assert pending.result(timeout=10)[0] == ("second", 8 << 20)
            assert client.call(first.address, "who", {}, frames=[b"z"],
                               timeout=10) == ("second", 1)
        finally:
            second.stop()
    finally:
        client.close()


def test_dead_peer_times_out_and_close_fails_pending():
    client = RpcClient()
    srv = RpcServer(name="dead").start()
    addr = srv.address
    srv.stop()
    try:
        t0 = time.monotonic()
        with pytest.raises(PeerUnavailableError, match="timed out"):
            client.call(addr, "anything", {}, timeout=0.4)
        assert time.monotonic() - t0 < 3.0
        fut = client.call_async(addr, "anything", {})
    finally:
        client.close()
    with pytest.raises(PeerUnavailableError):
        fut.result(timeout=5)
    with pytest.raises(PeerUnavailableError):
        client.call(addr, "anything", {}, timeout=0.4)


def test_concurrent_callers_get_their_own_replies():
    server = RpcServer(name="conc").start()
    server.register("echo", lambda msg, frames: (msg["k"], msg["i"]))
    client = RpcClient()
    errors = []

    def caller(k):
        try:
            for i in range(100):
                got = client.call(server.address, "echo",
                                  {"k": k, "i": i}, timeout=30)
                if got != (k, i):
                    errors.append((k, i, got))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
    finally:
        client.close()
        server.stop()


def test_chaos_drop_budget_times_out_then_recovers(monkeypatch):
    server = RpcServer(name="chaos-drop").start()
    calls = []
    server.register("op", lambda msg, frames: calls.append(1) or "ok")
    client = RpcClient()
    try:
        rpc_mod.set_chaos("op=2")
        for _ in range(2):
            with pytest.raises(PeerUnavailableError, match="timed out"):
                client.call(server.address, "op", {}, timeout=0.3)
        assert client.call(server.address, "op", {}, timeout=10) == "ok"
        assert calls == [1]  # the dropped sends never reached the server
        # a retried call rides through a drop budget of one
        rpc_mod.set_chaos("op=1")
        assert client.call(server.address, "op", {}, timeout=0.3,
                           retries=1) == "ok"
    finally:
        rpc_mod.set_chaos("")
        client.close()
        server.stop()


def test_chaos_delay_budget_delivers_late(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TESTING_RPC_DELAY_S", "0.5")
    server = RpcServer(name="chaos-delay").start()
    calls = []
    server.register("op", lambda msg, frames: calls.append(1) or "ok")
    client = RpcClient()
    try:
        rpc_mod.set_chaos("op=delay1")
        with pytest.raises(PeerUnavailableError, match="timed out"):
            client.call(server.address, "op", {}, timeout=0.2)
        deadline = time.monotonic() + 5
        while not calls and time.monotonic() < deadline:
            time.sleep(0.02)
        assert calls == [1]  # late, not lost: the straggler arrived
        fut = client.call_async(server.address, "op", {})
        assert fut.result(timeout=5)[0] == "ok"  # budget spent: on time
    finally:
        rpc_mod.set_chaos("")
        client.close()
        server.stop()


def test_close_while_connecting_raises_nothing_in_the_io_thread(
        monkeypatch):
    """A client closed while its connect is still in flight, and a write
    event that reaches a connection whose connect was abandoned (its
    socket already set to None, or its peer closed) after select
    returned it: nothing is raised in the ``rpc-client-io`` thread."""
    import selectors
    import socket

    errors = []
    monkeypatch.setattr(threading, "excepthook", errors.append)
    server = RpcServer(name="connect-race").start()
    try:
        for _ in range(50):
            client = RpcClient()
            client.send_oneway(server.address, "nothing", {})
            client.flush_oneways()  # the connect starts on the loop
            client.close()
        loop = rpc_mod._Loop("rpc-client-io")
        try:
            for abandon in ("sock_none", "peer_closed"):
                a, b = socket.socketpair()  # writable at once
                a.setblocking(False)
                conn = rpc_mod._Conn(loop, None, lambda c, p: None,
                                     lambda c: None)
                conn.sock = a
                connected = []
                conn.on_connect = lambda c: connected.append(
                    c.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR))

                def arm_then_abandon(conn=conn, abandon=abandon):
                    loop.add(conn, selectors.EVENT_WRITE)
                    if abandon == "sock_none":
                        conn.sock = None
                    else:
                        conn.closed = True

                loop.call_soon(arm_then_abandon)
                time.sleep(0.2)

                def unregister(a=a):
                    try:
                        loop._sel.unregister(a)
                    except (KeyError, ValueError, OSError):
                        pass

                loop.call_soon(unregister)
                time.sleep(0.05)
                a.close()
                b.close()
                assert connected == [], abandon
                assert loop._thread.is_alive(), abandon
        finally:
            loop.stop()
    finally:
        server.stop()
    assert [e for e in errors
            if e.thread is not None
            and e.thread.name == "rpc-client-io"] == [], errors
