"""Object spilling, push transfer and crashed readers on the port's
cluster runtime, through the JAX package's scenarios with their own
inputs and assertions: tests/test_spilling.py (5).

Reference parity: raylet/local_object_manager.h:41 (spill pinned
primaries under pressure, restore on access),
object_manager/push_manager.h:30 (proactive transfer toward consumers).
As in the JAX file, each store scenario boots its own one-node cluster
with a deliberately tiny (32 MiB) store, and the push scenario its own
two-node cluster. Functions are defined inside the tests, so they travel
by value. Every get carries a timeout.
"""

import gc
import os
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import exceptions as exc
from ray_tpu_torch.core.api import _global_runtime


@pytest.fixture
def small_store():
    """Driver with a deliberately tiny (32MB) local store."""
    ray.init(num_cpus=4, store_capacity=32 * 1024 * 1024)
    try:
        yield ray
    finally:
        ray.shutdown()


def test_put_beyond_capacity_spills_and_reads_back(small_store):
    """Put 10 x 8MB (2.5x store capacity) with all refs held: earlier
    primaries spill to disk; every object reads back intact."""
    refs, arrays = [], []
    for i in range(10):
        a = np.full(8 << 20, i, np.uint8)
        arrays.append(a)
        refs.append(ray.put(a))
    rt = _global_runtime()
    spilled = [b for b, st in rt._owned.items() if st.spilled_path]
    assert spilled, "no object was spilled despite store pressure"
    for i, r in enumerate(refs):
        out = ray.get(r, timeout=60)
        assert out[0] == i and out[-1] == i and len(out) == 8 << 20


def test_spilled_object_usable_as_task_arg(small_store):
    """A spilled primary is restored when a worker borrows it."""
    refs = [ray.put(np.full(8 << 20, i, np.uint8)) for i in range(8)]
    rt = _global_runtime()
    spilled = [b for b, st in rt._owned.items() if st.spilled_path]
    assert spilled

    @ray.remote(num_cpus=1)
    def head_byte(a):
        return int(a[0])

    vals = ray.get([head_byte.remote(r) for r in refs], timeout=120)
    assert vals == list(range(8))


def test_spill_files_cleaned_on_free(small_store):
    refs = [ray.put(np.full(8 << 20, i, np.uint8)) for i in range(8)]
    rt = _global_runtime()
    paths = [st.spilled_path for st in rt._owned.values() if st.spilled_path]
    assert paths and all(os.path.exists(p) for p in paths)
    del refs
    gc.collect()
    assert all(not os.path.exists(p) for p in paths)


def test_push_transfer_prefetches_arg():
    """Submitting a task whose big arg lives on node A while the task is
    pinned to node B triggers an owner-directed push: B's store holds the
    bytes without the worker having to pull them at exec time."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        nl_b = c.add_node(num_cpus=2, resources={"b": 2.0})
        c.wait_for_nodes()
        ray.init(address=c.address)
        arr = np.arange(1 << 20, dtype=np.uint8)
        ref = ray.put(arr)  # primary on the driver's node (A)
        oid = ref.id.binary()

        @ray.remote(resources={"b": 1.0}, num_cpus=0.1)
        def consume(a):
            return int(a[-1])

        assert ray.get(consume.remote(ref), timeout=60) == arr[-1]
        # the push landed a secondary copy in B's store
        assert nl_b.store.contains(oid)
    finally:
        ray.shutdown()
        c.shutdown()


def test_reader_crash_mid_get_does_not_wedge_store(small_store):
    """Kill a worker while it holds a zero-copy read view; the store must
    keep serving and the object must remain readable (crashed-reader
    refcount)."""
    big = ray.put(np.zeros(4 << 20, np.uint8))

    @ray.remote(num_cpus=1)
    def crash_while_reading(a):
        # `a` aliases the store; die without releasing the view
        os._exit(1)

    with pytest.raises(exc.RayTpuError):
        ray.get(crash_while_reading.remote(big), timeout=60)
    # store still serves reads and accepts new objects
    assert ray.get(big, timeout=60)[0] == 0
    for i in range(8):  # churn past capacity: eviction/spill still works
        ray.get(ray.put(np.full(4 << 20, i, np.uint8)), timeout=60)


def test_producer_results_spill_at_the_owner(small_store):
    """The port's addition beside the JAX scenarios: items a worker
    writes into a full store (a stream's items, a task's results) make
    room by asking their owner to spill its primaries there, so with
    every ref held the owner spills and each item reads back intact
    (the JAX package ships such an item inline to the owner instead)."""

    @ray.remote(num_cpus=1)
    def blocks(n):
        for i in range(n):
            yield np.full(8 << 20, i, np.uint8)

    @ray.remote(num_cpus=1)
    def block(i):
        return np.full(8 << 20, 100 + i, np.uint8)

    rt = _global_runtime()
    refs = list(blocks.options(num_returns="streaming").remote(6))
    refs += [block.remote(i) for i in range(4)]
    ready, _ = ray.wait(refs, num_returns=len(refs), timeout=120)
    assert len(ready) == len(refs)
    stats = dict(rt.spill_stats)
    assert stats["bytes"] >= 40 << 20, stats  # 80 MiB against 32 MiB
    inline = [b for b, st in rt._owned.items()
              if st.inline is not None and st.size >= 8 << 20]
    assert not inline, "a producer shipped an item inline"
    want = list(range(6)) + [100 + i for i in range(4)]
    for w, r in zip(want, refs):
        out = ray.get(r, timeout=60)
        assert out[0] == w and out[-1] == w and len(out) == 8 << 20


def test_concurrent_spill_requests_lose_nothing(small_store):
    """The port's addition: producers' spill requests run on the owner's
    RPC pool, so two can arrive at once. The owner spills one pass at a
    time, so neither pass unlinks a file the other committed, and every
    object, spilled or not, reads back intact."""
    rt = _global_runtime()
    refs = []
    for rnd in range(4):
        refs += [ray.put(np.full(8 << 20, 10 * rnd + i, np.uint8))
                 for i in range(3)]
        barrier = threading.Barrier(2)

        def ask():
            barrier.wait()
            rt._h_spill_request({"store_name": rt.store.name,
                                 "bytes": 8 << 20}, [])

        threads = [threading.Thread(target=ask) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    paths = [st.spilled_path for st in rt._owned.values() if st.spilled_path]
    assert len(paths) >= 8, rt.spill_stats
    assert all(os.path.exists(p) for p in paths)
    want = [10 * rnd + i for rnd in range(4) for i in range(3)]
    for w, r in zip(want, refs):
        out = ray.get(r, timeout=60)
        assert out[0] == w and out[-1] == w and len(out) == 8 << 20


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_value_outlives_its_ref(small_store, kind):
    """The port's addition: a value read zero-copy from the store keeps
    its bytes after its last ref is gone (plasma holds a client's buffer
    until it is released). 64 MiB of later results pass through the
    32 MiB store while the value lives, and it still reads as written."""

    @ray.remote(num_cpus=1)
    def block(i, kind):
        a = np.full(4 << 20, i, np.uint8)
        return torch.from_numpy(a) if kind == "torch" else a

    val = ray.get(block.remote(7, kind), timeout=60)
    gc.collect()
    rt = _global_runtime()
    rt._flush_deferred_sends()  # the free goes out now
    refs = [block.remote(100 + i, kind) for i in range(16)]
    ready, _ = ray.wait(refs, num_returns=len(refs), timeout=120)
    assert len(ready) == len(refs)
    assert int(val.min()) == 7 and int(val.max()) == 7
    for i, r in enumerate(refs):
        out = ray.get(r, timeout=60)
        assert int(out[0]) == 100 + i and int(out[-1]) == 100 + i
