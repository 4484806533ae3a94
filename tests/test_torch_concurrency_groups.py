"""Actor concurrency groups and async actors on the port's cluster
runtime, through the JAX package's scenarios with their own inputs and
assertions: tests/test_concurrency_groups.py (5).

Reference parity: ConcurrencyGroupManager
(src/ray/core_worker/transport/concurrency_group_manager.h:34 — named
groups with independent executor pools) and out-of-order async-actor
execution (out_of_order_actor_scheduling_queue.h). One module-scoped
one-node cluster, as the JAX fixture has. Actor classes are defined
inside the tests, so they travel by value. Every get carries a timeout.
"""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.core.exceptions import TaskError


@pytest.fixture(scope="module")
def ray_boot():
    ray.init(num_cpus=4)
    try:
        yield ray
    finally:
        ray.shutdown()


def test_slow_group_does_not_block_fast_group(ray_boot):
    @ray.remote(concurrency_groups={"io": 1, "compute": 1})
    class Worker:
        @ray.method(concurrency_group="io")
        def slow(self):
            time.sleep(3.0)
            return "slow"

        @ray.method(concurrency_group="compute")
        def fast(self):
            return "fast"

    w = Worker.remote()
    slow_ref = w.slow.remote()
    t0 = time.monotonic()
    assert ray.get(w.fast.remote(), timeout=30) == "fast"
    fast_latency = time.monotonic() - t0
    assert fast_latency < 1.5, \
        f"fast group stuck behind slow group ({fast_latency:.1f}s)"
    assert ray.get(slow_ref, timeout=30) == "slow"
    ray.kill(w)


def test_ordering_within_group(ray_boot):
    @ray.remote(concurrency_groups={"serial": 1})
    class Seq:
        def __init__(self):
            self.log = []

        @ray.method(concurrency_group="serial")
        def mark(self, i):
            self.log.append(i)
            return i

        @ray.method(concurrency_group="serial")
        def read(self):
            return list(self.log)

    s = Seq.remote()
    refs = [s.mark.remote(i) for i in range(20)]
    ray.get(refs, timeout=60)
    assert ray.get(s.read.remote(), timeout=30) == list(range(20))
    ray.kill(s)


def test_per_call_group_override(ray_boot):
    @ray.remote(concurrency_groups={"g1": 1})
    class A:
        def where(self):
            import threading

            return threading.current_thread().name

    a = A.remote()
    default_thread = ray.get(a.where.remote(), timeout=30)
    g1_thread = ray.get(
        a.where.options(concurrency_group="g1").remote(), timeout=30)
    assert "_default" in default_thread
    assert "g1" in g1_thread
    ray.kill(a)


def test_async_actor_out_of_order_completion(ray_boot):
    """An async method awaiting a long sleep must not block later short
    calls — completions land out of submission order."""

    @ray.remote
    class AsyncActor:
        async def wait_for(self, delay, tag):
            import asyncio

            await asyncio.sleep(delay)
            return tag

    a = AsyncActor.remote()
    slow = a.wait_for.remote(3.0, "slow")
    fast = a.wait_for.remote(0.05, "fast")
    t0 = time.monotonic()
    assert ray.get(fast, timeout=30) == "fast"
    assert time.monotonic() - t0 < 1.5, "async method blocked the actor"
    assert ray.get(slow, timeout=30) == "slow"
    ray.kill(a)


def test_async_actor_error_propagates(ray_boot):
    @ray.remote
    class Bad:
        async def boom(self):
            raise ValueError("async boom")

    b = Bad.remote()
    with pytest.raises(TaskError):
        ray.get(b.boom.remote(), timeout=30)
