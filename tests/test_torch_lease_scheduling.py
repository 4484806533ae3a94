"""Worker-lease reuse and arg-locality scheduling on the port's cluster
runtime, through the JAX package's scenarios with their own inputs and
assertions: tests/test_lease_scheduling.py (7).

Reference parity: lease reuse / pipelined pushes
(src/ray/core_worker/transport/normal_task_submitter.cc:137 OnWorkerIdle)
and locality-aware lessor choice (core_worker/lease_policy.h:58). As in
the JAX file, each scenario boots its own one-node cluster (their
assertions read the node's lease table and its free CPUs), and the
locality scenario its own two-node cluster. Functions are defined
inside the tests, so they travel by value. Every get carries a timeout.
"""

import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.api import _global_runtime
from ray_tpu_torch.core.exceptions import RayTpuError


@pytest.fixture
def ray_boot():
    ray.init(num_cpus=4)
    try:
        yield ray
    finally:
        ray.shutdown()


def test_lease_reuse_same_worker(ray_boot):
    """Repeated same-shape tasks run on ONE reused leased worker — no
    per-task scheduling hop, no process churn."""

    @ray.remote(num_cpus=1)
    def whoami():
        return os.getpid()

    pids = {ray.get(whoami.remote(), timeout=60) for _ in range(20)}
    assert len(pids) == 1, f"expected one leased worker, saw {pids}"


def test_lease_scales_out_under_backlog(ray_boot):
    """A burst larger than one worker's pipeline leases more workers."""

    @ray.remote(num_cpus=1)
    def slow():
        time.sleep(0.3)
        return os.getpid()

    pids = set(ray.get([slow.remote() for _ in range(8)], timeout=60))
    assert len(pids) >= 2, f"burst should fan out, saw {pids}"


def test_lease_returned_after_idle(ray_boot):
    """Idle leases are handed back to the nodelet (resources released)."""

    @ray.remote(num_cpus=1)
    def nop():
        return 1

    assert ray.get(nop.remote(), timeout=60) == 1
    nodelet = _global_runtime()._booted[1]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with nodelet._lock:
            if not nodelet._leases:
                break
        time.sleep(0.2)
    with nodelet._lock:
        assert not nodelet._leases, "lease not returned after idle"
    deadline = time.monotonic() + 5  # heartbeat-cached view refresh
    while time.monotonic() < deadline:
        if ray.available_resources().get("CPU") == 4.0:
            break
        time.sleep(0.2)
    assert ray.available_resources().get("CPU") == 4.0


def test_leased_worker_death_is_retried(ray_boot, tmp_path):
    """A leased worker dying mid-task surfaces as a retryable failure:
    the nodelet's lease_broken notification makes the owner resubmit."""
    flag = str(tmp_path / "died_once")

    @ray.remote(num_cpus=1, max_retries=2)
    def die_once():
        if not os.path.exists(flag):
            open(flag, "w").close()
            os._exit(1)
        return "recovered"

    assert ray.get(die_once.remote(), timeout=60) == "recovered"


def test_leased_worker_death_no_retries_errors(ray_boot):
    @ray.remote(num_cpus=1, max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(RayTpuError):
        ray.get(die.remote(), timeout=60)


# ---------------------------------------------------------------------------
# arg locality
# ---------------------------------------------------------------------------

def test_arg_locality_prefers_data_node():
    """A task consuming a large remote-stored arg runs on the node that
    holds the bytes (lease_policy.h:58 semantics)."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        c.add_node(num_cpus=2, resources={"data_node": 1.0})
        c.wait_for_nodes()
        ray.init(address=c.address)

        @ray.remote(resources={"data_node": 0.1}, num_cpus=0.1)
        def produce():
            return np.zeros(1 << 20, np.uint8)  # 1MB -> store-resident

        @ray.remote(num_cpus=0.1)
        def consume(a):
            import ray_tpu_torch as rt

            return (int(a.nbytes),
                    rt.get_runtime_context().node_id.hex())

        ref = produce.remote()
        ray.get(ref, timeout=60)  # materialized on the data node
        data_node = [n for n in ray.nodes()
                     if "data_node" in n["Resources"]][0]["NodeID"]
        nbytes, ran_on = ray.get(consume.remote(ref), timeout=60)
        assert nbytes == 1 << 20
        assert ran_on == data_node, "task did not follow its large arg"
    finally:
        ray.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# lease TTL expiry: expiry must notify the owner
# ---------------------------------------------------------------------------

def test_lease_expiry_then_worker_death_recovers(ray_boot):
    """TTL expiry must not silently clear the lease: a later worker death
    has to reach the owner as lease_broken (and the worker rejects stale
    pushes), so the owner resubmits and the task completes."""

    @ray.remote(num_cpus=1, max_retries=2)
    def slow():
        time.sleep(8)
        return "done"

    ref = slow.remote()
    nodelet = _global_runtime()._booted[1]
    # wait for the lease grant, then force-expire it mid-flight
    pid = None
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        with nodelet._lock:
            if nodelet._leases:
                for le in nodelet._leases.values():
                    le.expiry = 0.0
                    pid = le.worker.proc.pid
                break
        time.sleep(0.05)
    assert pid is not None, "no lease ever granted"
    # wait for the reap loop to expire it (sends lease_broken now)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with nodelet._lock:
            if not nodelet._leases:
                break
        time.sleep(0.05)
    # kill the worker: without the expiry notice this would hang
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    assert ray.get(ref, timeout=60) == "done"
