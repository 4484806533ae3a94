"""Task-level label selectors and soft node affinity on the port's
cluster runtime, through the JAX package's scenarios with their own
inputs and assertions: tests/test_label_scheduling.py (5).

Reference model: node_affinity_scheduling_policy.h:29 (hard pins fail
when the node is gone, soft falls back) and the label-match scheduling
tests. One module-scoped cluster (a 2-CPU head node and a 2-CPU node in
zone "b"), as the JAX fixture has. The JAX file's module-level `where`
task comes from a factory here, so it travels by value. Every get
carries a timeout.
"""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        c.add_node(num_cpus=2, labels={"zone": "b"})
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()


@pytest.fixture(scope="module")
def where(cluster):
    @ray.remote
    def where():
        return ray.get_runtime_context().node_id.hex()

    return where


def test_task_hard_node_affinity_lands_on_target(where):
    nodes = [n for n in ray.nodes() if n["Alive"]]
    assert len(nodes) == 2
    for n in nodes:
        ref = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            n["NodeID"])).remote()
        assert ray.get(ref, timeout=60) == n["NodeID"]


def test_task_label_selector_routes_to_matching_node(where):
    zone_b = [n for n in ray.nodes()
              if n["Labels"].get("zone") == "b"][0]
    refs = [where.options(scheduling_strategy=NodeLabelSchedulingStrategy(
        {"zone": "b"})).remote() for _ in range(4)]
    assert set(ray.get(refs, timeout=60)) == {zone_b["NodeID"]}


def test_task_soft_affinity_falls_back_when_node_gone(where):
    dead_id = "ff" * 14  # no such node
    ref = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        dead_id, soft=True)).remote()
    out = ray.get(ref, timeout=60)
    assert out in {n["NodeID"] for n in ray.nodes()}


def test_task_hard_affinity_to_dead_node_waits(where):
    dead_id = "ff" * 14
    ref = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        dead_id)).remote()
    with pytest.raises(Exception):  # noqa: B017 — timeout-class error
        ray.get(ref, timeout=3)
    # the cluster keeps working around the held task
    t0 = time.time()
    assert ray.get(where.remote(), timeout=60)
    assert time.time() - t0 < 60


def test_actor_soft_affinity_falls_back(cluster):
    @ray.remote
    class A:
        def whereami(self):
            return ray.get_runtime_context().node_id.hex()

    a = A.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        "ff" * 14, soft=True)).remote()
    out = ray.get(a.whereami.remote(), timeout=60)
    assert out in {n["NodeID"] for n in ray.nodes()}
    ray.kill(a)
