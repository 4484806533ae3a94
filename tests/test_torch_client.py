"""The port's thin client (ray_tpu_torch/client.py: the proxy, one host
process a client, the mirrored API) through the scenarios of
tests/test_client.py (7): tasks, actors, put/get, refs as args, named
actors, wait and isolation between clients, on one module-scoped cluster
of the port (a 4-CPU head node, the JAX fixture's). Functions and classes
are defined inside the tests, so they cross to the host by value."""

import numpy as np
import pytest

from ray_tpu_torch import client as rc
from ray_tpu_torch.cluster_utils import Cluster


def _settle(max_wait_s: float = 15.0):
    """Settle barrier (the JAX file's): give the load average a bounded
    chance to drop before booting the proxy cluster, so dying worker
    processes of a file run just before do not bleed CPU into the
    timing-sensitive wait test; an idle box passes straight through."""
    import os
    import time

    t0 = time.monotonic()
    target = max(1.5, 0.75 * (os.cpu_count() or 1))
    while time.monotonic() - t0 < max_wait_s:
        try:
            load1 = os.getloadavg()[0]
        except OSError:
            return
        if load1 < target:
            return
        time.sleep(1.0)


@pytest.fixture(scope="module")
def proxy():
    _settle()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    p = rc.start_client_server(c.address)
    # warm the worker pool through the proxy so the first timed test
    # never pays cold-start scheduling latency on a contended box
    warm = rc.connect(f"ray://{p.address}")
    try:
        warm.get(warm.put(1))
    finally:
        warm.disconnect()
    yield p
    p.stop()
    c.shutdown()


@pytest.fixture
def ctx(proxy):
    ctx = rc.connect(f"ray://{proxy.address}")
    yield ctx
    ctx.disconnect()


def test_remote_task_roundtrip(ctx):
    @ctx.remote(num_cpus=0.1)
    def add(a, b):
        return a + b

    assert ctx.get(add.remote(2, 3)) == 5


def test_put_get_and_refs_as_args(ctx):
    """The thin client has NO local store: values flow through the host
    (reference: client-mode object transport)."""
    ref = ctx.put(np.arange(10_000))
    assert int(ctx.get(ref).sum()) == 49995000

    @ctx.remote(num_cpus=0.1)
    def total(a):
        return int(a.sum())

    assert ctx.get(total.remote(ref)) == 49995000


def test_chained_task_refs(ctx):
    @ctx.remote(num_cpus=0.1)
    def double(x):
        return x * 2

    r = double.remote(double.remote(double.remote(1)))
    assert ctx.get(r) == 8


def test_actor_lifecycle(ctx):
    @ctx.remote(num_cpus=0.1)
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert ctx.get(c.inc.remote()) == 11
    assert ctx.get(c.inc.remote(5)) == 16
    ctx.kill(c)


def test_named_actor_from_client(ctx):
    @ctx.remote(num_cpus=0.1)
    class Store:
        def __init__(self):
            self.v = "hello"

        def read(self):
            return self.v

    Store.options(name="client-named").remote()
    h = ctx.get_actor("client-named")
    assert ctx.get(h.read.remote()) == "hello"
    ctx.kill(h)


def test_wait(ctx):
    import time as _t

    @ctx.remote(num_cpus=0.1)
    def slow(t):
        _t.sleep(t)
        return t

    # budgets widened from (5s task, 10s window) per the ROADMAP flake
    # note: the slow task must outlast the whole wait window so it is
    # still pending when wait returns, but stay bounded — its worker
    # keeps sleeping after this test, and an over-long pin would bleed
    # into the next test's pool exactly like the stale-lease wedge did
    fast, slow_ref = slow.remote(0.05), slow.remote(15)
    ready, pending = ctx.wait([fast, slow_ref], num_returns=1, timeout=12)
    assert ready == [fast] and pending == [slow_ref]


def test_two_clients_isolated_hosts(proxy):
    """Each client gets its OWN server-side driver (reference:
    proxier.py one SpecificServer per client)."""
    a = rc.connect(proxy.address)
    b = rc.connect(proxy.address)
    try:
        assert a._host != b._host
        ra = a.put("from-a")
        assert a.get(ra) == "from-a"

        @b.remote(num_cpus=0.1)
        def who():
            return "b"

        assert b.get(who.remote()) == "b"
    finally:
        a.disconnect()
        b.disconnect()
