"""Deterministic RPC fault injection on the port's cluster runtime,
through the JAX package's scenarios with their own inputs and
assertions: tests/test_chaos.py (5).

Reference model: src/ray/rpc/rpc_chaos.h:23 + RAY_testing_rpc_failure —
drop the first N sends of a method and assert the retry path recovers.
As in the JAX file, each scenario boots its own one-node cluster (a
chaos budget armed in one must not leak into the next). Functions and
classes are defined inside the tests, so they travel by value. Every
get carries a timeout.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import rpc


@pytest.fixture
def chaos_cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        rpc.set_chaos("")  # disarm
        ray.shutdown()
        c.shutdown()


def test_task_submit_survives_dropped_schedule_rpc(chaos_cluster):
    """submit_task sends schedule_task with retries=2; dropping the first
    send must be invisible to the caller, and the nodelet-side dedup must
    not double-run the task when both the dropped-then-retried and any
    slow duplicate arrive."""

    @ray.remote(num_cpus=0.1)
    def bump(x):
        return x + 1

    # warm up: function export + worker spawn happen without chaos
    assert ray.get(bump.remote(1), timeout=60) == 2

    rpc.set_chaos("schedule_task=1")
    assert ray.get(bump.remote(10), timeout=60) == 11


def test_actor_call_survives_dropped_rpc(chaos_cluster):
    """Dropping the first actor_call send exercises the submit retry
    loop; the worker-side task_id dedup keeps actor state correct even
    when a retry races a slow (not lost) original."""

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert ray.get(c.incr.remote(), timeout=60) == 1

    # actor calls are at-most-once by default; retries are opt-in
    # (reference: max_task_retries, python/ray/actor.py) — and the
    # worker-side task_id dedup makes the opt-in retry exactly-once.
    rpc.set_chaos("actor_call=1")
    assert ray.get(c.incr.options(max_task_retries=2).remote(),
                   timeout=120) == 2
    rpc.set_chaos("")
    # exactly-once effect: no hidden duplicate increment
    assert ray.get(c.incr.remote(), timeout=60) == 3


def test_resolve_retry_after_drop(chaos_cluster):
    """Borrower resolve path retries after a dropped resolve RPC."""

    @ray.remote(num_cpus=0.1)
    def make():
        return np.arange(10)

    @ray.remote(num_cpus=0.1)
    def consume(a):
        return int(a.sum())

    ref = make.remote()
    assert ray.get(ref, timeout=60) is not None
    rpc.set_chaos("resolve=1")
    # worker resolving the borrowed arg hits its own (worker-process)
    # chaos budget only via env; driver-side drop exercises our wait path
    assert ray.get(consume.remote(ref), timeout=90) == 45


def test_lease_request_drop_falls_back(chaos_cluster):
    """Dropping the lease grant forces the classic scheduling path —
    the task still completes (submitter-side fallback)."""

    @ray.remote(num_cpus=0.2)
    def val(x):
        return x * 3

    assert ray.get(val.remote(2), timeout=60) == 6  # warm
    rpc.set_chaos("request_lease=2")
    assert ray.get(val.remote(5), timeout=90) == 15
    rpc.set_chaos("")


def test_leased_push_drop_recovered_by_ack_sweeper(chaos_cluster):
    """A dropped execute_leased push never reaches the worker; the
    submitter's ack sweeper resends after the (shortened) ack timeout,
    and worker-side dedup keeps it exactly-once."""
    os.environ["RAY_TPU_ACK_TIMEOUT_S"] = "2"  # env reads are uncached

    @ray.remote(num_cpus=0.2)
    def bump(x):
        return x + 100

    try:
        assert ray.get(bump.remote(1), timeout=60) == 101  # warm lease
        rpc.set_chaos("execute_leased=1")
        assert ray.get(bump.remote(7), timeout=90) == 107
    finally:
        rpc.set_chaos("")
        os.environ.pop("RAY_TPU_ACK_TIMEOUT_S", None)
