"""The port's cluster launcher (ray_tpu_torch/launcher.py: `up` and
`down` through the local provider, the v2 reconciler adopting launched
workers, the CLI's `up`/`down`) and the v1 demand scheduler through the
scenarios of tests/test_launcher.py (7), and the demand scheduler's
packing held against the JAX package's on the same demands. Each launch
boots `python -m ray_tpu_torch.scripts.cli start` processes, as the JAX
scenarios do with theirs; the state lives under each test's tmp_path.
"""

import os
import time

import pytest
import yaml

import ray_tpu_torch as ray_tpu
from ray_tpu import autoscaler as jax_autoscaler
from ray_tpu_torch import autoscaler, launcher
from ray_tpu_torch.autoscaler import ResourceDemandScheduler


def _config(tmp_path, workers=2):
    return {
        "cluster_name": "lt",
        "max_workers": 4,
        "provider": {"type": "local"},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 2.0}, "min_workers": 0},
            "worker": {"resources": {"CPU": 1.0}, "min_workers": workers},
        },
        "initialization_commands": [],
        "setup_commands": ["true"],  # exercises the setup phase
    }


@pytest.fixture
def launched(tmp_path):
    state_dir = str(tmp_path / "clusters")
    cfg = _config(tmp_path)
    state = launcher.up(cfg, state_dir=state_dir)
    yield state, state_dir
    try:
        launcher.down("lt", state_dir=state_dir)
    except FileNotFoundError:
        pass


def test_up_boots_head_and_workers(launched):
    """VERDICT done-criterion: up boots head+2 workers from a YAML on
    one box; all three register with the head."""
    state, _ = launched
    assert state["head"]["status"] == launcher.RUNNING
    assert len(state["workers"]) == 2
    assert all(w["status"] == launcher.RUNNING for w in state["workers"])

    ray_tpu.init(address=state["head"]["address"])
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            nodes = [n for n in ray_tpu.nodes() if n["Alive"]]
            if len(nodes) >= 3:
                break
            time.sleep(0.5)
        assert len(nodes) == 3
        total = ray_tpu.cluster_resources()
        assert total.get("CPU", 0) == 4.0  # 2 head + 2x1 worker

        @ray_tpu.remote
        def f(x):
            return x * 2

        assert ray_tpu.get(f.remote(21), timeout=60) == 42
    finally:
        ray_tpu.shutdown()


def test_down_terminates_processes(tmp_path):
    state_dir = str(tmp_path / "clusters")
    state = launcher.up(_config(tmp_path, workers=1), state_dir=state_dir)
    pids = [state["head"]["pid"]] + [w["pid"] for w in state["workers"]]
    assert all(launcher.pid_alive(pid) for pid in pids)
    launcher.down("lt", state_dir=state_dir)
    deadline = time.time() + 15
    while time.time() < deadline:
        gone = sum(0 if launcher.pid_alive(pid) else 1 for pid in pids)
        if gone == len(pids):
            break
        time.sleep(0.2)
    assert gone == len(pids)
    assert not os.path.exists(
        os.path.join(state_dir, "lt.json"))


def test_autoscaler_v2_adopts_launched_workers(launched):
    """VERDICT done-criterion: the v2 reconciler adopts nodes it did not
    launch itself (reference: reconciler adoption of unknown cloud
    instances)."""
    from ray_tpu_torch.autoscaler_v2 import RAY_RUNNING, Reconciler

    state, state_dir = launched
    provider = launcher.LaunchedNodeProvider("lt", state_dir=state_dir)
    rec = Reconciler(state["head"]["address"], provider,
                     min_workers=0, max_workers=4)
    deadline = time.time() + 30
    adopted = []
    while time.time() < deadline:
        rec.reconcile()
        adopted = rec.storage.list(RAY_RUNNING)
        if len(adopted) >= 2:
            break
        time.sleep(0.5)
    assert len(adopted) == 2
    ids = {i.node_id for i in adopted}
    assert ids == {bytes.fromhex(w["node_id_hex"])
                   for w in state["workers"]}


def test_cli_up_down_roundtrip(tmp_path):
    from ray_tpu_torch.scripts.cli import main

    state_dir = str(tmp_path / "clusters")
    yml = tmp_path / "cluster.yaml"
    yml.write_text(yaml.safe_dump(_config(tmp_path, workers=1)))
    assert main(["up", str(yml), "--state-dir", state_dir]) == 0
    st = launcher.load_state("lt", state_dir=state_dir)
    assert len(st["workers"]) == 1
    assert main(["down", "lt", "--state-dir", state_dir]) == 0
    assert not os.path.exists(os.path.join(state_dir, "lt.json"))


def test_failed_setup_command_raises(tmp_path):
    cfg = _config(tmp_path, workers=0)
    cfg["setup_commands"] = ["false"]
    with pytest.raises(RuntimeError, match="setup command failed"):
        launcher.up(cfg, state_dir=str(tmp_path / "clusters"))


# ----------------------------------------------- demand scheduler (v1)


def test_demand_scheduler_packs_onto_cheapest_type():
    """Bin-packing chooses the type that satisfies each shape cheapest
    (reference: resource_demand_scheduler.py:102)."""
    sched = ResourceDemandScheduler({
        "small": {"resources": {"CPU": 2.0}, "cost": 1.0},
        "big": {"resources": {"CPU": 8.0, "TPU": 4.0}, "cost": 5.0},
    }, max_workers=10)
    # CPU-only demand → cheap small nodes, packed 2-per-node
    plan = sched.get_nodes_to_launch(
        [{"CPU": 1.0}] * 4, existing_headroom=[], existing_count=0)
    assert plan == {"small": 2}
    # TPU demand opens ONE big node; CPU demand then rides its spare
    # capacity instead of launching more smalls
    plan = sched.get_nodes_to_launch(
        [{"CPU": 1.0}] * 4 + [{"TPU": 2.0}],
        existing_headroom=[], existing_count=0)
    assert plan == {"big": 1}
    # existing headroom absorbs demand first
    plan2 = sched.get_nodes_to_launch(
        [{"CPU": 1.0}], existing_headroom=[{"CPU": 4.0}],
        existing_count=1)
    assert plan2 == {}
    # budget respected
    plan3 = sched.get_nodes_to_launch(
        [{"CPU": 2.0}] * 9, existing_headroom=[], existing_count=8)
    assert sum(plan3.values()) <= 2


def test_demand_scheduler_infeasible_shape_skipped():
    sched = ResourceDemandScheduler(
        {"small": {"resources": {"CPU": 2.0}}}, max_workers=4)
    plan = sched.get_nodes_to_launch(
        [{"GPU": 1.0}, {"CPU": 1.0}], existing_headroom=[],
        existing_count=0)
    assert plan == {"small": 1}  # GPU shape infeasible, CPU shape packed


_TYPES = {
    "small": {"resources": {"CPU": 2.0}, "cost": 1.0},
    "big": {"resources": {"CPU": 8.0, "TPU": 4.0}, "cost": 5.0,
            "max_workers": 2},
    "gpu": {"resources": {"CPU": 4.0, "GPU": 1.0}, "cost": 3.0},
}


@pytest.mark.parametrize("seed", range(6))
def test_demand_scheduler_packing_matches_jax(seed):
    """Seeded demand shapes, headroom and per-type counts through both
    packages' schedulers give the same launch plans."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = [{"CPU": 1.0}, {"CPU": 2.0}, {"CPU": 1.0, "GPU": 1.0},
              {"TPU": 2.0}, {"TPU": 4.0, "CPU": 4.0}, {"GPU": 2.0},
              {"CPU": 0.5}]
    picks = rng.integers(len(shapes), size=int(rng.integers(1, 12)))
    demands = [dict(shapes[int(i)]) for i in picks]
    headroom = [{"CPU": float(rng.integers(0, 4))}
                for _ in range(int(rng.integers(0, 3)))]
    count = int(rng.integers(0, 4))
    by_type = {"big": int(rng.integers(0, 3))}
    max_workers = int(rng.integers(2, 8))
    plans = [mod.ResourceDemandScheduler(_TYPES, max_workers)
             .get_nodes_to_launch(demands, headroom, count, by_type)
             for mod in (jax_autoscaler, autoscaler)]
    assert plans[0] == plans[1]
