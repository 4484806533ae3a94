"""Lineage reconstruction on the port's cluster runtime: lost task
outputs are re-executed. The JAX package's scenarios with their own
inputs and assertions: tests/test_reconstruction.py (8, five of them
slow as in the JAX file).

One module-scoped head node with a driver; each scenario adds (and
kills) volatile nodes, and the per-test fixture strips them again, as
the JAX fixtures do. Functions and classes are defined inside the
tests, so they travel by value. Every get and wait carries a timeout.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import api
from ray_tpu_torch.core import exceptions as exc
from ray_tpu_torch.core import rpc as rpc_mod


@pytest.fixture(scope="module")
def _module_cluster():
    """ONE head + stable node + driver for the whole module: cluster
    boot + init + worker warmup are paid once instead of per test."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()


def _alive() -> int:
    return sum(1 for n in ray.nodes() if n["Alive"])


@pytest.fixture
def two_node_cluster(_module_cluster):
    c = _module_cluster
    yield c
    # tests add (and kill) volatile nodes; strip everything but the
    # stable head node and wait for the head to age the dead ones out,
    # so every test starts from the same 1-alive-node state a fresh
    # cluster would give it
    for nl in list(c.nodelets[1:]):
        try:
            c.remove_node(nl)
        except Exception:  # noqa: BLE001
            pass
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if _alive() == 1:
            return
        time.sleep(0.2)
    raise RuntimeError("extra nodes did not age out of the cluster view")


def test_lost_object_reconstructed_after_node_death(two_node_cluster):
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 1.0}, max_retries=2)
    def produce():
        # large result -> lives in the producing node's store
        return np.arange(500_000, dtype=np.int64)

    ref = produce.remote()
    # wait until the task completed (location recorded) WITHOUT fetching
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    # the producing node dies; its store bytes are gone
    c.remove_node(volatile)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if _alive() == 1:
            break
        time.sleep(0.3)
    # re-add capacity so the reconstructed task can run somewhere
    c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    arr = ray.get(ref, timeout=180)
    assert int(arr.sum()) == 124999750000


def test_put_objects_are_not_reconstructable(two_node_cluster):
    """put() has no lineage — a lost put-object must raise, not hang
    (reference semantics)."""
    rt = api._runtime
    ref = ray.put(np.arange(200_000))
    b = ref.id.binary()
    with rt._lock:
        st = rt._owned[b]
    # simulate loss: wipe the local store copy behind the runtime's back
    st.has_cached = False
    st.value_cached = None
    rt.store.release(b)
    rt.store.delete(b)
    with pytest.raises(exc.ObjectLostError):
        ray.get(ref, timeout=30)


def _kill_volatile_and_recover(c, handle):
    """Remove the volatile node, wait for death detection, re-add
    capacity for reconstructed tasks."""
    c.remove_node(handle)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if _alive() == 1:
            break
        time.sleep(0.3)
    c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()


@pytest.mark.slow  # as in the JAX file: covered by faster siblings
def test_nested_lost_chain_reconstructed(two_node_cluster):
    """A → B → C all on the dying node: getting C forces C's
    re-execution, whose lost ARG (B) is reconstructed owner-side when
    the executing worker reports the dead location, recursively down to
    A."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1}, max_retries=4)
    def produce():
        return np.arange(300_000, dtype=np.int64)  # store-resident

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1}, max_retries=4)
    def bump(a):
        return a + 1

    a = produce.remote()
    b = bump.remote(a)
    c3 = bump.remote(b)
    ready, _ = ray.wait([c3], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)
    arr = ray.get(c3, timeout=180)
    assert int(arr[0]) == 2 and int(arr[-1]) == 300_001


@pytest.mark.slow  # as in the JAX file: covered by faster siblings
def test_reconstruction_racing_concurrent_borrowers(two_node_cluster):
    """Two consumers hit the same lost object concurrently: exactly one
    reconstruction runs (event-guarded) and both complete."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1}, max_retries=4)
    def produce():
        return np.ones(300_000, dtype=np.int64)

    @ray.remote(num_cpus=0.1, max_retries=4)
    def consume(a, tag):
        return int(a.sum()) + tag

    ref = produce.remote()
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)
    outs = ray.get([consume.remote(ref, 1), consume.remote(ref, 2)],
                   timeout=180)
    assert sorted(outs) == [300_001, 300_002]


@pytest.mark.slow  # as in the JAX file: covered by faster siblings
def test_reconstruction_under_rpc_chaos(two_node_cluster):
    """Reconstruction still converges when the resubmission RPCs drop
    their first attempts (deterministic chaos budgets, ref
    rpc/rpc_chaos.h)."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1}, max_retries=4)
    def produce():
        return np.full(300_000, 7, dtype=np.int64)

    ref = produce.remote()
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)
    # drop the next schedule_task send from THIS (owner) process: the
    # reconstruction submission itself must retry through the drop
    rpc_mod.set_chaos("schedule_task=1")
    try:
        arr = ray.get(ref, timeout=180)
        assert int(arr.sum()) == 7 * 300_000
    finally:
        rpc_mod.set_chaos("")


@pytest.mark.slow  # as in the JAX file: covered by faster siblings
def test_actor_results_not_reconstructable(two_node_cluster):
    """Actor task outputs carry no lineage (reference: actor task
    results are not rebuilt by the recovery manager) — a lost one
    surfaces an error instead of hanging."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1})
    class Holder:
        def big(self):
            return np.zeros(300_000, dtype=np.int64)

    h = Holder.remote()
    ref = h.big.remote()
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)
    with pytest.raises(exc.RayTpuError):
        ray.get(ref, timeout=30)


def test_retry_budget_exhaustion_raises(two_node_cluster):
    """max_retries=0: a lost output must raise promptly rather than loop
    (budget is consumed by reconstruction attempts)."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1}, max_retries=0)
    def produce():
        return np.arange(300_000, dtype=np.int64)

    ref = produce.remote()
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)
    with pytest.raises(exc.RayTpuError):
        ray.get(ref, timeout=60)


@pytest.mark.slow  # as in the JAX file: covered by faster siblings
def test_nested_chain_with_consumer_on_stable_node(two_node_cluster):
    """The dead node held ONLY the intermediates; a stable-node consumer
    task transparently waits out the owner-driven reconstruction of its
    borrowed arg (lost_at report path)."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 0.1}, max_retries=4)
    def produce():
        return np.arange(300_000, dtype=np.int64)

    ref = produce.remote()
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)

    @ray.remote(num_cpus=0.1, max_retries=2)
    def total(a):
        return int(a.sum())

    assert ray.get(total.remote(ref), timeout=180) == 44999850000


def test_get_of_lost_object_skips_dead_holder_timeouts(two_node_cluster):
    """The port's repair beside the JAX scenarios: a pull from a node the
    head's view lists as dead fails at once, so the owner starts the
    reconstruction without first waiting out the pull's RPC timeouts
    (~40 s on this fixture before the repair, as in the JAX package)."""
    c = two_node_cluster
    volatile = c.add_node(num_cpus=2, resources={"volatile": 2.0})
    c.wait_for_nodes()

    @ray.remote(num_cpus=0.1, resources={"volatile": 1.0}, max_retries=2)
    def produce():
        return np.arange(400_000, dtype=np.int64)

    ref = produce.remote()
    ready, _ = ray.wait([ref], timeout=60)
    assert ready
    _kill_volatile_and_recover(c, volatile)
    t0 = time.monotonic()
    arr = ray.get(ref, timeout=180)
    assert int(arr[-1]) == 399_999
    assert time.monotonic() - t0 < 20.0
