"""Streaming generators (num_returns="streaming" / ObjectRefStream) on
the port's runtime, through the JAX package's scenarios with their own
inputs and assertions: tests/test_streaming.py (14: three in local
mode, eleven on a two-node cluster, two of them the data layer's
streaming reads on the cluster runtime), and the data executor's memory
budget following the store's configured capacity there.

One module-scoped cluster (a 4-CPU head node and a 4-CPU node), as the
JAX fixture has. Functions and classes are defined inside the tests, so
they travel by value. Every get carries a timeout.
"""

import os
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster

# ---------------------------------------------------------------- local mode


def test_local_stream_basic():
    ray.init(local_mode=True)
    try:
        @ray.remote
        def gen(n):
            for i in range(n):
                yield i * 10

        out = [ray.get(ref, timeout=30) for ref in
               gen.options(num_returns="streaming").remote(5)]
        assert out == [0, 10, 20, 30, 40]
    finally:
        ray.shutdown()


def test_local_stream_error_and_consume_as_produced():
    ray.init(local_mode=True)
    try:
        @ray.remote
        def gen():
            yield 1
            yield 2
            raise ValueError("boom")

        g = gen.options(num_returns="streaming").remote()
        assert ray.get(next(g), timeout=30) == 1
        assert ray.get(next(g), timeout=30) == 2
        with pytest.raises(Exception, match="boom"):
            next(g)

        # consume-as-produced: first item arrives before the producer ends
        @ray.remote
        def slow():
            yield "fast"
            time.sleep(5)
            yield "slow"

        g2 = slow.options(num_returns="streaming").remote()
        t0 = time.monotonic()
        assert ray.get(next(g2), timeout=30) == "fast"
        assert time.monotonic() - t0 < 3.0
        g2.close()
    finally:
        ray.shutdown()


def test_local_stream_actor_and_close():
    ray.init(local_mode=True)
    try:
        @ray.remote
        class Counter:
            def stream(self, n):
                for i in range(n):
                    yield i

        c = Counter.remote()
        g = c.stream.options(num_returns="streaming").remote(3)
        assert [ray.get(r, timeout=30) for r in g] == [0, 1, 2]

        # early close stops the producer promptly (backpressure-bounded)
        produced = []

        @ray.remote
        def endless():
            i = 0
            while True:
                produced.append(i)
                yield i
                i += 1

        g2 = endless.options(
            num_returns="streaming",
            generator_backpressure_num_objects=4).remote()
        assert ray.get(next(g2), timeout=30) == 0
        g2.close()
        time.sleep(0.5)
        n_after_close = len(produced)
        time.sleep(0.5)
        assert len(produced) == n_after_close  # producer stopped
        assert n_after_close <= 8
    finally:
        ray.shutdown()


# ---------------------------------------------------------------- cluster


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


def test_stream_task_basic(cluster):
    @ray.remote
    def gen(n):
        for i in range(n):
            yield {"i": i}

    g = gen.options(num_returns="streaming").remote(7)
    out = [ray.get(ref, timeout=60)["i"] for ref in g]
    assert out == list(range(7))


def test_stream_consume_before_producer_done(cluster):
    @ray.remote
    def slow_gen():
        yield "first"
        time.sleep(8)
        yield "second"

    g = slow_gen.options(num_returns="streaming").remote()
    t0 = time.monotonic()
    first = ray.get(next(g), timeout=60)
    dt = time.monotonic() - t0
    assert first == "first"
    assert dt < 5.0, f"first item took {dt:.1f}s — not streamed"
    assert ray.get(next(g), timeout=60) == "second"
    with pytest.raises(StopIteration):
        next(g)


def test_stream_large_items_via_store(cluster):
    @ray.remote
    def blocks(n):
        for i in range(n):
            yield np.full((1 << 16,), i, dtype=np.float32)  # 256 KiB

    g = blocks.options(num_returns="streaming").remote(4)
    for i, ref in enumerate(g):
        arr = ray.get(ref, timeout=60)
        assert arr.shape == (1 << 16,)
        assert arr[0] == i


def test_stream_actor_method(cluster):
    @ray.remote
    class Producer:
        def chunks(self, n):
            for i in range(n):
                yield f"chunk-{i}"

    p = Producer.remote()
    g = p.chunks.options(num_returns="streaming").remote(5)
    assert [ray.get(r, timeout=60) for r in g] == \
        [f"chunk-{i}" for i in range(5)]


def test_stream_borrower_iterates(cluster):
    """A generator handle passed to another process: the consumer task
    iterates items as the producer yields them (owner = driver)."""

    @ray.remote
    def gen(n):
        for i in range(n):
            yield i * i

    @ray.remote
    def consume(g):
        return [ray.get(r, timeout=60) for r in g]

    g = gen.options(num_returns="streaming").remote(6)
    assert ray.get(consume.remote(g), timeout=60) == [i * i for i in range(6)]


def test_stream_producer_death_mid_stream(cluster):
    """Producer actor dies mid-stream: already-consumed items stay
    valid; iteration past the last delivered item raises."""

    @ray.remote(max_restarts=0)
    class Doomed:
        def stream(self):
            yield 1
            yield 2
            time.sleep(0.3)  # let the item oneways flush before dying
            os._exit(1)

    d = Doomed.remote()
    g = d.stream.options(num_returns="streaming").remote()
    assert ray.get(next(g), timeout=60) == 1
    assert ray.get(next(g), timeout=60) == 2
    with pytest.raises(Exception):
        # either the death error, or StopIteration converted by iteration
        for _ in range(10):
            ray.get(next(g), timeout=60)


def test_stream_backpressure(cluster):
    """Producer must stall once produced-consumed hits the cap."""
    progress = tempfile.mktemp()

    @ray.remote
    def gen(path, n):
        for i in range(n):
            with open(path, "w") as f:
                f.write(str(i + 1))
            yield i

    g = gen.options(
        num_returns="streaming",
        generator_backpressure_num_objects=3).remote(progress, 50)
    first = ray.get(next(g), timeout=60)
    assert first == 0
    time.sleep(2.0)  # producer would finish all 50 in ms without BP
    with open(progress) as f:
        produced = int(f.read())
    assert produced <= 10, f"produced {produced} with backpressure=3"
    # drain; producer unblocks as we consume
    rest = [ray.get(r, timeout=60) for r in g]
    assert rest == list(range(1, 50))
    os.unlink(progress)


def test_stream_early_close_cancels_producer(cluster):
    progress = tempfile.mktemp()

    @ray.remote
    def endless(path):
        i = 0
        while True:
            with open(path, "w") as f:
                f.write(str(i))
            yield i
            i += 1
            time.sleep(0.01)

    g = endless.options(num_returns="streaming").remote(progress)
    assert ray.get(next(g), timeout=60) == 0
    g.close()
    time.sleep(1.5)  # close propagates via the sweeper + cancel oneway
    with open(progress) as f:
        at_close = int(f.read())
    time.sleep(1.0)
    with open(progress) as f:
        later = int(f.read())
    assert later - at_close <= 5, "producer kept running after close"
    os.unlink(progress)


def test_data_streaming_read_consumes_as_produced(cluster):
    """read_datasource(streaming=True): iter_batches yields rows from
    block 0 while the producer is still sleeping before block 1."""
    from ray_tpu_torch.data import Datasource, read_datasource

    class SlowSource(Datasource):
        def get_block_streams(self, parallelism):
            def gen():
                yield list(range(100))
                time.sleep(6)
                yield list(range(100, 200))

            return [gen]

    ds = read_datasource(SlowSource(), streaming=True)
    it = ds.iter_batches(batch_size=50, batch_format=None)
    t0 = time.monotonic()
    first = next(it)
    dt = time.monotonic() - t0
    assert first == list(range(50))
    assert dt < 4.0, f"first batch took {dt:.1f}s — read not streamed"
    rest = [row for b in it for row in b]
    assert rest == list(range(50, 200))


def test_data_streaming_read_files(cluster, tmp_path):
    """Grouped file read with streaming=True produces one block per
    file and survives transforms."""
    from ray_tpu_torch.data import read_text

    for i in range(4):
        (tmp_path / f"f{i}.txt").write_text(
            "\n".join(f"l{i}-{j}" for j in range(10)) + "\n")
    ds = read_text(str(tmp_path), parallelism=2, streaming=True)
    rows = ds.map(lambda s: s.upper()).take_all()
    assert len(rows) == 40
    assert sorted(rows)[0] == "L0-0"


def test_stream_retry_on_worker_crash(cluster):
    """Streaming task whose worker dies is retried; the replayed items
    dedup at the owner and iteration completes."""
    marker = tempfile.mktemp()

    @ray.remote(max_retries=2, retry_exceptions=True)
    def flaky(n, path):
        first = not os.path.exists(path)
        if first:
            with open(path, "w") as f:
                f.write("x")
        for i in range(n):
            if first and i == 2:
                raise RuntimeError("synthetic mid-stream crash")
            yield i

    g = flaky.options(num_returns="streaming").remote(5, marker)
    out = [ray.get(r, timeout=60) for r in g]
    assert out == list(range(5))
    os.unlink(marker)


def test_data_memory_budget_follows_store_capacity(cluster, monkeypatch):
    """The data executor's default memory budget is a quarter of the
    store capacity that RAY_TPU_OBJECT_STORE_BYTES configures (as the
    JAX package's executor reads it), and an execution on the cluster
    runtime sizes its blocks against it."""
    from ray_tpu_torch.data import executor, range as data_range

    def budget():
        return [p for p in executor.default_policies()
                if isinstance(p, executor.MemoryBudgetBackpressurePolicy)
                ][0].budget

    assert budget() == 512 * 1024 * 1024 // 4  # the config's default
    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_BYTES", str(96 << 20))
    assert budget() == (96 << 20) // 4
    # the explicit argument still wins
    assert executor.default_policies(memory_budget=123)[1].budget == 123
    ds = data_range(64, parallelism=4).map(lambda r: r * 2)
    assert sorted(ds.take_all()) == [2 * i for i in range(64)]
    ex = ds._last_executor
    assert [p.budget for p in ex.policies if isinstance(
        p, executor.MemoryBudgetBackpressurePolicy)] == [(96 << 20) // 4]
    # block sizes come from the cluster runtime's ownership table
    assert ex.stats.peak_buffered_bytes > 0
