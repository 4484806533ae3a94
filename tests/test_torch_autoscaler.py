"""The port's v1 autoscaler (ray_tpu_torch/autoscaler.py) through the
scenarios of tests/test_autoscaler.py (2) on one module-scoped cluster of
the port (a 1-CPU head node, the JAX fixture's), and its pure demand
functions held against the JAX package's on the same inputs: the scale-up
signal `compute_demand`, `idle_node_ids` and `collect_demand_bundles`.
Functions are defined inside the tests, so they travel by value. Every
get carries a timeout."""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu import autoscaler as jax_autoscaler
from ray_tpu_torch import autoscaler
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig,
    FakeNodeProvider,
    StandardAutoscaler,
)
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    c.wait_for_nodes()
    ray.init(address=c.address)
    yield c
    ray.shutdown()
    c.shutdown()


def test_scale_up_on_queued_demand_and_down_when_idle(cluster, tmp_path):
    provider = FakeNodeProvider(
        cluster.address,
        {"worker": {"resources": {"CPU": 4.0}}},
        session_dir=str(tmp_path / "as"))
    scaler = StandardAutoscaler(
        cluster.address, provider,
        AutoscalerConfig(min_workers=0, max_workers=2,
                         idle_timeout_s=2.0, poll_interval_s=0.5))

    @ray.remote(num_cpus=1)
    def slow():
        time.sleep(1.0)
        return ray.get_runtime_context().node_id.hex()

    # 6 one-CPU tasks against a 1-CPU cluster: queue builds up
    refs = [slow.remote() for _ in range(6)]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not provider.non_terminated_nodes():
        scaler.reconcile()
        time.sleep(0.3)
    assert provider.non_terminated_nodes(), "no scale-up despite queue"
    assert scaler.num_launches >= 1

    nodes = set(ray.get(refs, timeout=120))
    assert len(nodes) >= 2  # new capacity actually ran work

    # drain, then idle nodes are reclaimed after the timeout
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline and provider.non_terminated_nodes():
        scaler.reconcile_down()
        time.sleep(0.5)
    assert not provider.non_terminated_nodes(), "idle node never reclaimed"
    assert scaler.num_terminations >= 1


def test_min_workers_kept(cluster, tmp_path):
    provider = FakeNodeProvider(
        cluster.address, {"worker": {"resources": {"CPU": 2.0}}},
        session_dir=str(tmp_path / "as2"))
    scaler = StandardAutoscaler(
        cluster.address, provider,
        AutoscalerConfig(min_workers=1, max_workers=3, idle_timeout_s=0.5))
    scaler.start()
    try:
        assert len(provider.non_terminated_nodes()) == 1
        time.sleep(2.5)  # well past idle timeout
        assert len(provider.non_terminated_nodes()) == 1  # floor holds
    finally:
        scaler.stop()
        for h in provider.non_terminated_nodes():
            provider.terminate_node(h)


# ---------------------------------------------------------------------------
# the demand functions against the JAX package's, on the same cluster views
# ---------------------------------------------------------------------------

_FULL = {"CPU": 4.0, "GPU": 1.0}
_VIEWS = {
    "idle": [{"node_id": b"a", "queue_len": 0, "resources": _FULL,
              "available": dict(_FULL)}],
    "queued_no_headroom": [
        {"node_id": b"a", "queue_len": 3, "resources": _FULL,
         "available": {"CPU": 0.5, "GPU": 1.0},
         "queued_demand": {"CPU": 3.0, "GPU": 0.0}}],
    "queued_with_headroom": [
        {"node_id": b"a", "queue_len": 2, "resources": _FULL,
         "available": {"CPU": 2.0, "GPU": 0.0},
         "queued_demand": {"GPU": 2.0}},
        {"node_id": b"b", "queue_len": 0, "resources": {"CPU": 1.0},
         "available": {"CPU": 1.0 - 1e-16}}],
    "fractional_residue": [
        {"node_id": b"c", "queue_len": 0, "resources": {"CPU": 1.0},
         "available": {"CPU": 0.30000000000000004 + 0.7 - 1e-12}},
        {"node_id": b"d", "queue_len": 0, "resources": {"CPU": 1.0},
         "available": {"CPU": 0.5}}],
}
_PGS = {
    "none": [],
    "pending": [{"state": "PENDING", "bundles": [{"CPU": 1.0, "GPU": 1.0}]}],
    "created": [{"state": "CREATED", "bundles": [{"CPU": 4.0}]},
                {"state": "PENDING", "bundles": [{"TPU": 4.0}] * 2}],
}


@pytest.mark.parametrize("view", sorted(_VIEWS))
@pytest.mark.parametrize("pgs", sorted(_PGS))
def test_demand_signals_match_jax(view, pgs):
    nodes, groups = _VIEWS[view], _PGS[pgs]
    assert autoscaler.compute_demand(nodes, groups) == \
        jax_autoscaler.compute_demand(nodes, groups)
    assert autoscaler.idle_node_ids(nodes) == \
        jax_autoscaler.idle_node_ids(nodes)
    assert autoscaler.collect_demand_bundles(nodes, groups) == \
        jax_autoscaler.collect_demand_bundles(nodes, groups)
