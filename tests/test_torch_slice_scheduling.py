"""Multi-host slice-bundle gang scheduling on the port's cluster
runtime, through the JAX package's scenarios with their own inputs and
assertions: tests/test_slice_scheduling.py (5).

Reference parity: bundle gang placement over pod slices
(src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h:82-106)
and slice identity from pod metadata (python/ray/_private/accelerators/
tpu.py:19-44). Fake hosts: cluster nodes asserting TPU:4 and slice
labels, two slices of two hosts, as the JAX fixture has. The placement
scenarios are the JAX ones whole. The trainer scenario keeps their
placement and rank-order assertions; the port sets no libtpu topology
env (a recorded deviation), so it asserts that ``TPU_WORKER_ID``,
``TPU_WORKER_HOSTNAMES``, ``TPU_ACCELERATOR_TYPE`` and ``TPU_NAME`` are
absent and that the process group's ranks follow the pack order. Every
wait carries a timeout.
"""

import json
import os

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import tpu as tpu_mod
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)


def _slice_labels(slice_name, worker_id, pod_type="v4-16"):
    return {
        tpu_mod.SLICE_LABEL: slice_name,
        tpu_mod.WORKER_ID_LABEL: str(worker_id),
        tpu_mod.POD_TYPE_LABEL: pod_type,
        tpu_mod.TOPOLOGY_LABEL: "2x2x2",
    }


@pytest.fixture(scope="module")
def slice_cluster():
    """Two fake slices x two fake hosts, TPU:4 each (a v4-16 pair)."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        nodes = {}
        for sl in ("slice-a", "slice-b"):
            for wid in (0, 1):
                nl = c.add_node(num_cpus=4, resources={"TPU": 4.0},
                                labels=_slice_labels(sl, wid))
                nodes[(sl, wid)] = nl.node_id.hex()
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c, nodes
    finally:
        ray.shutdown()
        c.shutdown()


def _labels_by_node_hex():
    return {n["NodeID"]: n.get("Labels") or {} for n in ray.nodes()}


def test_strict_pack_gang_one_slice_worker_order(slice_cluster):
    """A 2x{TPU:4} STRICT_PACK gang = a slice bundle: both bundles on the
    hosts of ONE slice, bundle i on TPU_WORKER_ID i."""
    pg = placement_group([{"TPU": 4.0}, {"TPU": 4.0}],
                         strategy="STRICT_PACK")
    assert pg.wait(30)
    placed = pg._state()["nodes"]
    labels = _labels_by_node_hex()
    slices = {labels[nid][tpu_mod.SLICE_LABEL] for nid in placed}
    assert len(slices) == 1, f"gang crossed slices: {slices}"
    wids = [int(labels[nid][tpu_mod.WORKER_ID_LABEL]) for nid in placed]
    assert wids == [0, 1], f"bundle->worker-id order wrong: {wids}"
    remove_placement_group(pg)


def test_spread_gang_prefers_distinct_slices(slice_cluster):
    """SPREAD with TPU bundles puts one gang member per DCN domain."""
    pg = placement_group([{"TPU": 2.0}, {"TPU": 2.0}], strategy="SPREAD")
    assert pg.wait(30)
    placed = pg._state()["nodes"]
    labels = _labels_by_node_hex()
    slices = {labels[nid][tpu_mod.SLICE_LABEL] for nid in placed}
    assert len(slices) == 2, f"SPREAD stayed within one slice: {slices}"
    remove_placement_group(pg)


def test_slice_head_marker_resource(slice_cluster):
    """Worker 0 of each slice asserts TPU-{pod_type}-head (reference:
    accelerators/tpu.py marker resource) so one task targets each slice."""
    total = ray.cluster_resources()
    assert total.get("TPU-v4-16-head") == 2.0  # one per slice


def test_strict_pack_single_host_still_packs(slice_cluster):
    """A gang that fits one host must not be force-spread."""
    pg = placement_group([{"TPU": 2.0}, {"TPU": 2.0}],
                         strategy="STRICT_PACK")
    assert pg.wait(30)
    placed = pg._state()["nodes"]
    assert len(set(placed)) == 1
    remove_placement_group(pg)


# ---------------------------------------------------------------------------
# End-to-end: a trainer gang lands one worker per host of one slice, its
# process group's ranks in the pack order.
# ---------------------------------------------------------------------------

def _probe_loop_factory():
    def probe_loop(config):
        import torch.distributed as dist

        import ray_tpu_torch as rt
        from ray_tpu_torch import train

        ctx = train.get_context()
        my_node = os.environ["RAY_TPU_NODE_ID"]
        labels = {n["NodeID"]: n.get("Labels") or {}
                  for n in rt.nodes()}[my_node]
        row = {
            "rank": ctx.get_world_rank(),
            "pg_rank": dist.get_rank(),
            "pg_world": dist.get_world_size(),
            "tpu_worker_id": int(labels["ray.io/tpu-worker-id"]),
            "slice": labels["ray.io/tpu-slice"],
            "node_rank": ctx.get_node_rank(),
            "local_world_size": ctx.get_local_world_size(),
            "world_size": ctx.get_world_size(),
            "libtpu_env": sorted(
                k for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                            "TPU_ACCELERATOR_TYPE", "TPU_NAME")
                if k in os.environ),
        }
        with open(os.path.join(config["out"], f"{row['rank']}.json"),
                  "w") as f:
            json.dump(row, f)
        train.report({k: row[k] for k in
                      ("rank", "tpu_worker_id", "node_rank")})

    return probe_loop


def test_trainer_gang_slice_topology(slice_cluster, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    out = tmp_path / "rows"
    out.mkdir()
    trainer = TorchTrainer(
        _probe_loop_factory(),
        train_loop_config={"out": str(out)},
        scaling_config=ScalingConfig(
            num_workers=2,
            use_gpu=False,
            resources_per_worker={"CPU": 1.0, "TPU": 4.0},
            placement_strategy="STRICT_PACK",
            num_cpu_devices_per_worker=1,
        ),
        run_config=RunConfig(name="slice_gang", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    # rank i landed on slice worker i (bundle->worker-id order)
    assert result.metrics_history[0]["tpu_worker_id"] == \
        result.metrics_history[0]["rank"]
    rows = [json.loads((out / f"{r}.json").read_text()) for r in (0, 1)]
    assert len({r["slice"] for r in rows}) == 1  # one slice
    for r in rows:
        assert r["tpu_worker_id"] == r["rank"] == r["pg_rank"]
        assert r["pg_world"] == r["world_size"] == 2
        assert r["local_world_size"] == 1  # one worker per host
        assert r["libtpu_env"] == []  # no libtpu topology env (deviation)
