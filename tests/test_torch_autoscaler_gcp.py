"""The port's GCP TPU queued-resources provider
(ray_tpu_torch/autoscaler_gcp.py, the JAX module as it is) through the
scenarios of tests/test_autoscaler_gcp.py (7): the slice-shape parse,
the mocked API's lifecycle and stockouts, and the provider against a
live head of the port (one module-scoped cluster, a 1-CPU head node, the
JAX fixture's). The parse and the mocked API's state sequences are held
against the JAX package's on the same inputs."""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu import autoscaler_gcp as jax_gcp
from ray_tpu_torch import autoscaler_gcp
from ray_tpu_torch.autoscaler import AutoscalerConfig, StandardAutoscaler
from ray_tpu_torch.autoscaler_gcp import (
    ACTIVE,
    FakeTPUQueuedResourceAPI,
    GCPTPUNodeProvider,
    slice_shape,
)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import tpu as tpu_mod
from ray_tpu_torch.util.placement_group import (
    placement_group,
    placement_group_table,
    remove_placement_group,
)


# ---------------------------------------------------------------------------
# pure units
# ---------------------------------------------------------------------------

def test_slice_shape_parsing():
    assert slice_shape("v4-8") == (2, 4)
    assert slice_shape("v4-16") == (4, 4)
    assert slice_shape("v5p-8") == (2, 4)
    assert slice_shape("v3-8") == (1, 4)  # 8 cores = 1 host of 4 chips
    assert slice_shape("v2-32") == (4, 4)
    with pytest.raises(ValueError):
        slice_shape("tpu")


@pytest.mark.parametrize("accel", ["v2-8", "v2-32", "v3-8", "v3-2048",
                                   "v4-8", "v4-16", "v4-4096", "v5p-8",
                                   "v5litepod-16", "v6e-256", "v4-2",
                                   "tpu", "v4-x", "v4"])
def test_slice_shape_matches_jax(accel):
    def parse(fn):
        try:
            return fn(accel)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(slice_shape) == parse(jax_gcp.slice_shape)


def test_fake_api_lifecycle():
    api = FakeTPUQueuedResourceAPI(provision_polls=2)
    api.create_queued_resource("s1", "v4-16")
    st1 = api.get_queued_resource("s1")["state"]
    assert st1 != ACTIVE, "became ACTIVE on first poll"
    qr = api.get_queued_resource("s1")
    assert qr["state"] == ACTIVE
    assert len(qr["hosts"]) == 4  # all hosts appear together
    api.delete_queued_resource("s1")
    with pytest.raises(KeyError):
        api.get_queued_resource("s1")


def test_fake_api_stockout_injection():
    api = FakeTPUQueuedResourceAPI(provision_polls=1)
    api.fail_next_creations(1)
    api.create_queued_resource("bad", "v4-8")
    assert api.get_queued_resource("bad")["state"] == "FAILED"
    api.create_queued_resource("good", "v4-8")
    assert api.get_queued_resource("good")["state"] == ACTIVE


@pytest.mark.parametrize("polls,fails", [(1, 0), (2, 1), (3, 2)])
def test_fake_api_state_sequences_match_jax(polls, fails):
    """The same creations, polls and deletes through both mocked APIs
    give the same states, hosts and call counts."""
    def drive(mod):
        api = mod.FakeTPUQueuedResourceAPI(provision_polls=polls)
        api.fail_next_creations(fails)
        seen = []
        for i, accel in enumerate(("v4-8", "v4-16", "v3-8")):
            api.create_queued_resource(f"s{i}", accel)
        for _ in range(polls + 1):
            for i in range(3):
                qr = api.get_queued_resource(f"s{i}")
                seen.append((qr["state"], qr.get("num_hosts"),
                             [h["hostname"] for h in qr.get("hosts", [])]))
        api.delete_queued_resource("s1")
        seen.append(sorted(q["name"] for q in api.list_queued_resources()))
        return seen, api.create_calls, api.delete_calls

    assert drive(autoscaler_gcp) == drive(jax_gcp)


# ---------------------------------------------------------------------------
# provider against a live head
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    c.wait_for_nodes()
    ray.init(address=c.address)
    yield c
    ray.shutdown()
    c.shutdown()


def _wait_hosts(provider, n, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        hosts = [h for h in provider.non_terminated_nodes()
                 if provider.node_id(h)]
        if len(hosts) >= n:
            return hosts
        time.sleep(0.2)
    raise AssertionError(f"never saw {n} active hosts")


def test_slice_provisioning_registers_labeled_hosts(cluster, tmp_path):
    """An ACTIVE queued resource boots every host of the slice with
    slice-identity labels and the TPU-head marker on worker 0."""
    provider = GCPTPUNodeProvider(
        cluster.address,
        {"tpu": {"accelerator_type": "v4-16", "cpus_per_host": 2,
                 "topology": "2x2x2"}},
        session_dir=str(tmp_path / "gcp"))
    provider.create_node("tpu")
    # pending slices count toward capacity accounting before ACTIVE
    assert len(provider.non_terminated_nodes()) >= 1
    hosts = _wait_hosts(provider, 4)
    assert {h.worker_id for h in hosts} == {0, 1, 2, 3}

    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        view = [n for n in ray.nodes()
                if n["Labels"].get(tpu_mod.SLICE_LABEL) and n["Alive"]]
        if len(view) == 4:
            break
        time.sleep(0.2)
    assert len(view) == 4, "hosts never registered with the head"
    heads = [n for n in view if "TPU-v4-16-head" in n["Resources"]]
    assert len(heads) == 1
    assert heads[0]["Labels"][tpu_mod.WORKER_ID_LABEL] == "0"
    assert all(n["Resources"].get("TPU") == 4.0 for n in view)
    assert all(n["Labels"][tpu_mod.TOPOLOGY_LABEL] == "2x2x2"
               for n in view)
    provider.terminate_node(hosts[0])


def test_slice_delete_is_atomic(cluster, tmp_path):
    """Terminating any host of a slice removes the WHOLE slice (pod
    slices are indivisible), and the queued resource is deleted."""
    provider = GCPTPUNodeProvider(
        cluster.address,
        {"tpu": {"accelerator_type": "v4-8", "cpus_per_host": 1}},
        session_dir=str(tmp_path / "gcp2"))
    provider.create_node("tpu")
    hosts = _wait_hosts(provider, 2)
    provider.terminate_node(hosts[1])
    assert provider.non_terminated_nodes() == []
    assert provider.api.delete_calls == 1


def test_failed_provisioning_cleaned_up(cluster, tmp_path):
    api = FakeTPUQueuedResourceAPI(provision_polls=1)
    api.fail_next_creations(1)
    provider = GCPTPUNodeProvider(
        cluster.address,
        {"tpu": {"accelerator_type": "v4-8"}},
        api=api, session_dir=str(tmp_path / "gcp3"))
    provider.create_node("tpu")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not provider.failed_slices:
        provider.poll()
        time.sleep(0.1)
    assert provider.failed_slices, "stockout never surfaced"
    assert provider.non_terminated_nodes() == []


def test_autoscaler_e2e_scales_tpu_slice_for_pending_pg(cluster, tmp_path):
    """The TPU-native end-to-end: a STRICT_PACK slice-gang placement
    group is PENDING → the autoscaler asks the provider for a slice →
    hosts register → the PG is placed across the slice in worker-id
    order."""
    provider = GCPTPUNodeProvider(
        cluster.address,
        {"tpu": {"accelerator_type": "v4-16", "cpus_per_host": 2}},
        session_dir=str(tmp_path / "gcp4"))
    scaler = StandardAutoscaler(
        cluster.address, provider,
        AutoscalerConfig(min_workers=0, max_workers=4, node_type="tpu",
                         idle_timeout_s=60.0))

    pg = placement_group([{"TPU": 4.0}] * 4, strategy="STRICT_PACK")
    deadline = time.monotonic() + 60
    placed = False
    try:
        while time.monotonic() < deadline:
            scaler.reconcile()  # also advances queued-resource provisioning
            if pg.wait(1):
                placed = True
                break
            time.sleep(0.3)
        assert placed, "slice-gang PG never placed on autoscaled slice"
        assert scaler.num_launches >= 1
        table = placement_group_table(pg)
        assert table["state"] == "CREATED"
    finally:
        remove_placement_group(pg)
        for h in list(provider.non_terminated_nodes()):
            provider.terminate_node(h)
