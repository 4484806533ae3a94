"""Borrow release and chunked node-to-node transfer on the port's
cluster runtime, through the JAX package's scenarios with their own
inputs and assertions: tests/test_object_plane.py (3).

Reference model: python/ray/tests/test_reference_counting*.py (borrower
release frees the owner's memory) and the object manager's chunked
transfer (object_manager.h:117). One module-scoped cluster (a 4-CPU
head node and a 4-CPU node), as the JAX fixture has. Every get carries
a timeout.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        c.add_node(num_cpus=4)
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()


def _store_objects(nodelet) -> int:
    return nodelet.store.stats()["num_objects"]


def test_borrow_then_drop_frees_owner_memory(cluster):
    """A worker that borrowed (and released) a big object must not pin it
    in the owner's store forever: when the driver also drops its ref, the
    bytes are reclaimed."""
    nl = cluster.nodelets[0]

    @ray.remote(num_cpus=0.1)
    def consume(a):
        return int(a[0]) + int(a[-1])

    before = _store_objects(nl)
    big = ray.put(np.arange(1_000_000))  # ~8MB -> store path
    assert ray.get(consume.remote(big), timeout=60) == 999999
    # drop the driver's last reference
    del big
    gc.collect()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if _store_objects(nl) <= before:
            break
        time.sleep(0.2)
    assert _store_objects(nl) <= before, (
        f"object leaked in store: {nl.store.stats()}")


def test_chunked_node_to_node_transfer(cluster):
    """A result bigger than the pull chunk size transfers node-to-node in
    bounded chunks and arrives intact."""

    @ray.remote(num_cpus=0.1, resources={"maker": 1.0})
    def make_big():
        return np.arange(3_000_000, dtype=np.int64)  # 24MB > 4MB chunk

    # pin production to a third node so the driver (attached to node 0)
    # must pull across nodes
    maker = cluster.add_node(num_cpus=2, resources={"maker": 2.0})
    cluster.wait_for_nodes()
    try:
        ref = make_big.remote()
        arr = ray.get(ref, timeout=120)
        assert arr.shape == (3_000_000,)
        assert int(arr[12345]) == 12345
        assert int(arr.sum()) == 4499998500000
        # the driver-side fetch went through its local nodelet's chunked
        # pull (6 chunks for 24MB at 4MB)
        assert cluster.nodelets[0]._pull_chunks_served >= 6
    finally:
        cluster.remove_node(maker)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if sum(1 for n in ray.nodes() if n["Alive"]) == 2:
                break
            time.sleep(0.3)


def test_large_roundtrip_through_store(cluster):
    """Zero-copy write + read of a large array via put/get."""
    a = np.random.RandomState(0).rand(2_000_000)  # 16MB
    ref = ray.put(a)
    b = ray.get(ref, timeout=60)
    np.testing.assert_array_equal(a, b)
