"""A nodelet's stop() leaves no worker process behind: every worker it
knew is gone and reaped when stop() returns, and a worker spawned once
stop() has begun is stopped at once instead of registered (the port's
cluster runtime, ray_tpu_torch.core.nodelet, on the CPU)."""

import os

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster


def _worker_children() -> list[int]:
    """Pids of this process's children that run a worker."""
    me = str(os.getpid())
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if rest[1] == me and rest[0] != "Z" and \
                b"ray_tpu_torch.core.worker_main" in cmd:
            out.append(int(name))
    return out


def test_stop_reaps_every_worker_and_refuses_new_ones():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    nl = c.nodelets[0]
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)

        @ray.remote(num_cpus=1)
        class A:
            def pid(self):
                return os.getpid()

        actors = [A.remote() for _ in range(2)]
        pids = ray.get([a.pid.remote() for a in actors], timeout=60)
        assert len(set(pids)) == 2
        with nl._lock:
            workers = list(nl._workers.values())
        assert {w.proc.pid for w in workers} >= set(pids)
    finally:
        ray.shutdown()
        c.shutdown()
    # reaped, not only signalled, by the time stop() returns
    assert all(w.proc.returncode is not None for w in workers)
    with pytest.raises(RuntimeError, match="nodelet stopped"):
        nl._spawn_worker()
    assert _worker_children() == []
