"""The port's Tuner (ray_tpu_torch.tune.tuner) on the port's cluster
runtime, each trial an actor in its own worker process, through every
scenario of tests/test_tune.py with the JAX test's inputs and
assertions: a random sweep of 20 trials, a grid's cross product, ASHA
stopping bad trials, restore completing pending trials, the GPT-2-tiny
learning-rate sweep, PBT against fixed hyperparameters, PBT over a
training loop (a torch step in place of the jitted one), and median
stopping. The JAX tests marked slow stay slow. Added: trainer-in-trial,
a trial whose trainable runs a one-worker `TorchTrainer` (the trial's
actor drives a gang of its own), and trials in distinct processes.

One module-scoped cluster: a head node of 8 CPUs (the JAX fixture's)
with 2 warm workers. Trainables are made by factories or inside the
tests (qualnames with ``<locals>``), so they travel by value; they name
only importable modules. Every get and wait has a timeout.
"""

import json
import os

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import tune
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import RunConfig


@pytest.fixture(scope="module")
def cluster():
    """Module-scoped, as the JAX fixture: trials only ever add actors,
    never nodes."""
    c = Cluster(initialize_head=True)
    os.environ["RAY_TPU_PRESTART_WORKERS"] = "2"
    try:
        c.add_node(num_cpus=8)
    finally:
        os.environ.pop("RAY_TPU_PRESTART_WORKERS", None)
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()


def _quadratic_fn():
    def quadratic(config):
        # minimum at x=3; lr controls convergence speed
        import os

        x = 0.0
        for _ in range(20):
            x -= config["lr"] * 2 * (x - 3.0)
            tune.report({"objective": (x - 3.0) ** 2, "x": x,
                         "pid": os.getpid()})

    return quadratic


def test_random_sweep_20_trials(cluster, tmp_path):
    tuner = tune.Tuner(
        _quadratic_fn(),
        param_space={"lr": tune.loguniform(1e-3, 0.5)},
        tune_config=tune.TuneConfig(metric="objective", mode="min",
                                    num_samples=20, seed=7,
                                    max_concurrent_trials=4),
        run_config=RunConfig(name="sweep20", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 20
    assert not grid.errors
    best = grid.get_best_result()
    assert best.metrics["objective"] < 0.5
    assert best.config["lr"] > 0.01  # higher lr converges further in 20 steps
    # each trial ran in a worker process of its own, not in the driver
    pids = {r.metrics["pid"] for r in grid}
    assert len(pids) == 20 and os.getpid() not in pids


def test_grid_search_cross_product(cluster, tmp_path):
    tuner = tune.Tuner(
        _quadratic_fn(),
        param_space={"lr": tune.grid_search([0.01, 0.1, 0.4])},
        tune_config=tune.TuneConfig(metric="objective", mode="min"),
        run_config=RunConfig(name="grid", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 3
    lrs = sorted(r.config["lr"] for r in grid)
    assert lrs == [0.01, 0.1, 0.4]


def test_asha_stops_bad_trials(cluster, tmp_path):
    def slow_loss(config):
        for i in range(30):
            tune.report({"loss": config["level"] + 0.001 * i})

    tuner = tune.Tuner(
        slow_loss,
        param_space={"level": tune.grid_search([1.0, 2.0, 3.0, 4.0,
                                                5.0, 6.0, 7.0, 8.0])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=8,
            scheduler=tune.ASHAScheduler(max_t=30, grace_period=5,
                                         reduction_factor=2)),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    stopped = [r for r in grid
               if r.metrics.get("training_iteration", 0) < 30]
    finished = [r for r in grid
                if r.metrics.get("training_iteration", 0) == 30]
    assert finished, "some trials must survive to max_t"
    assert stopped, "ASHA must cut some underperformers early"
    # the best level should be among the finishers
    assert min(r.config["level"] for r in finished) == 1.0


def test_tuner_restore_completes_pending(cluster, tmp_path):
    """Simulate an interrupted sweep: state on disk has a PENDING trial;
    restore() runs it and the grid is complete."""
    tuner = tune.Tuner(
        _quadratic_fn(),
        param_space={"lr": tune.grid_search([0.05, 0.2])},
        tune_config=tune.TuneConfig(metric="objective", mode="min"),
        run_config=RunConfig(name="resume", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 2

    # forge an interruption: mark one trial pending again
    state_file = os.path.join(str(tmp_path), "resume", "tuner_state.json")
    with open(state_file) as f:
        state = json.load(f)
    state["trials"][1]["status"] = "RUNNING"  # as if it died mid-flight
    with open(state_file, "w") as f:
        json.dump(state, f)

    restored = tune.Tuner.restore(os.path.join(str(tmp_path), "resume"),
                                  _quadratic_fn())
    grid2 = restored.fit()
    assert len(grid2) == 2
    assert not grid2.errors
    assert all(r.metrics for r in grid2)


@pytest.mark.slow  # as the JAX test (tier-1 budget)
def test_gpt2_tiny_lr_sweep(cluster, tmp_path):
    """Sweep the GPT-2-tiny learning rate on the CPU; best config
    reported (4 trials, as the JAX test)."""

    def train_gpt2(config):
        import numpy as np
        import torch

        from ray_tpu_torch.models.gpt2 import (
            GPT2Config,
            gpt2_loss,
            init_gpt2,
        )
        from ray_tpu_torch.train import adamw
        from ray_tpu_torch.train.spmd import TrainState, make_train_step

        torch.set_num_threads(2)
        cfg = GPT2Config.tiny(vocab_size=256, block_size=32)
        gen = torch.Generator().manual_seed(0)
        tx = adamw(config["lr"])
        state = TrainState.create(init_gpt2(gen, cfg, device="cpu"), tx)
        rng = np.random.RandomState(0)
        toks = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (2, cfg.block_size + 1)).astype(np.int64))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
        for _ in range(5):
            state, metrics = step_fn(state, batch)
            tune.report({"loss": float(metrics["loss"])})

    tuner = tune.Tuner(
        train_gpt2,
        param_space={"lr": tune.grid_search([1e-5, 1e-3, 5e-2, 0.5])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="gpt2lr", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    assert not grid.errors
    best = grid.get_best_result()
    assert best.config["lr"] in (1e-3, 5e-2)


# ---------------------------------------------------------------------------
# Population Based Training
# ---------------------------------------------------------------------------

def _pbt_progress_fn():
    def pbt_progress(config):
        """Synthetic PBT objective: score is accumulated progress `x`;
        good `lr` trials advance fast. Exploit clones x (the checkpoint)
        so a bad trial teleports to the leader's state; explore perturbs
        lr."""
        import time as _t

        state = tune.get_checkpoint() or {"x": 0.0}
        x = state["x"]
        for _ in range(24):
            x += config["lr"]
            tune.report({"score": x}, checkpoint={"x": x})
            _t.sleep(0.03)

    return pbt_progress


_PBT_LRS = [0.001, 0.002, 0.005, 1.0]


def _run_population(scheduler, tmp_path, name):
    tuner = tune.Tuner(
        _pbt_progress_fn(),
        param_space={"lr": tune.grid_search(_PBT_LRS)},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=scheduler,
                                    max_concurrent_trials=4),
        run_config=RunConfig(name=name, storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert not grid.errors
    return sorted(r.metrics["score"] for r in grid)


@pytest.mark.slow  # as the JAX test (tier-1 budget)
def test_pbt_beats_fixed_hyperparams(cluster, tmp_path):
    """PBT's exploit/explore lifts the population: the mean final score
    beats the same population with fixed hyperparameters."""
    fixed = _run_population(None, tmp_path, "pbt_fixed")
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=6,
        hyperparam_mutations={"lr": [0.5, 1.0, 2.0]}, seed=3)
    evolved = _run_population(pbt, tmp_path, "pbt_evolved")
    assert pbt.exploit_count >= 1
    assert sum(evolved) > sum(fixed) * 2, (fixed, evolved)
    # the exploited stragglers specifically must have been lifted
    assert evolved[0] > fixed[0] * 10


def test_pbt_over_torch_training_smoke(cluster, tmp_path):
    """PBT over a torch train loop: checkpoints are param lists cloned
    across trial actors in their own processes (the JAX test's jitted
    step, as a torch step)."""

    def torch_trainable(config):
        import torch

        w = tune.get_checkpoint()
        w = torch.tensor(w["w"]) if w else torch.zeros(4)
        target = torch.arange(4.0)

        def step(w, lr):
            g = 2 * (w - target)
            return w - lr * g

        for _ in range(10):
            w = step(w, config["lr"])
            loss = float(torch.sum((w - target) ** 2))
            tune.report({"loss": loss}, checkpoint={"w": list(map(float, w))})

    pbt = tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.05, 0.2]}, seed=0)
    tuner = tune.Tuner(
        torch_trainable,
        param_space={"lr": tune.grid_search([0.001, 0.2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=pbt,
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="pbt_torch", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert not grid.errors
    assert grid.get_best_result().metrics["loss"] < 0.1


def test_median_stopping_rule_cuts_stragglers(cluster, tmp_path):
    sched = tune.MedianStoppingRule(metric="score", mode="max",
                                    grace_period=3)
    scores = _run_population(sched, tmp_path, "median_stop")
    assert scores[-1] > 20  # leader ran to completion


# ------------------------------------------------------ trainer-in-trial


def test_trainer_in_trial(cluster, tmp_path):
    """A trial whose trainable fits a one-worker TorchTrainer: the
    trial's actor drives its own gang, whose loop runs in another
    process, and reports the trainer's result to Tune."""
    storage = str(tmp_path)

    def trainer_trial(config):
        import os

        from ray_tpu_torch.train import (
            RunConfig as TrainRunConfig,
            ScalingConfig,
            TorchTrainer,
        )

        def loop(loop_config):
            import os

            import torch.distributed as dist

            import ray_tpu_torch.train as train

            x = 0.0
            for step in range(loop_config["steps"]):
                x += loop_config["lr"]
                train.report({"x": x, "step": step, "pid": os.getpid(),
                              "world": dist.get_world_size()})

        result = TorchTrainer(
            loop, train_loop_config={"steps": 3, "lr": config["lr"]},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=TrainRunConfig(
                name=f"inner_{config['lr']}", storage_path=storage),
        ).fit()
        tune.report({"x": result.metrics["x"],
                     "steps": len(result.metrics_history),
                     "loop_pid": result.metrics["pid"],
                     "world": result.metrics["world"],
                     "trial_pid": os.getpid()})

    tuner = tune.Tuner(
        trainer_trial,
        param_space={"lr": tune.grid_search([0.5, 2.0])},
        tune_config=tune.TuneConfig(metric="x", mode="max",
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="trainer_in_trial",
                             storage_path=storage),
    )
    grid = tuner.fit()
    assert not grid.errors, grid.errors[0].error
    best = grid.get_best_result()
    assert best.config["lr"] == 2.0 and best.metrics["x"] == 6.0
    for r in grid:
        m = r.metrics
        assert m["steps"] == 3 and m["world"] == 1
        assert len({m["loop_pid"], m["trial_pid"], os.getpid()}) == 3


def test_gpu_trials_share_a_card(cluster, tmp_path):
    """trial_resources={"CPU": 1, "GPU": 0.5}: two trials at once on a
    node with one (asserted) GPU, each in its own process, each shown
    the card (CUDA_VISIBLE_DEVICES handed through, not emptied as for a
    trial that claims no GPU)."""
    gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
    cluster.wait_for_nodes()
    try:
        def where(config):
            import os
            import time as _t

            for i in range(6):
                _t.sleep(0.1)
                tune.report({
                    "pid": os.getpid(), "i": i,
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "node": ray.get_runtime_context().get_node_id()})

        grids = {}
        for name, res in (("gpu", {"CPU": 1.0, "GPU": 0.5}),
                          ("cpu", {"CPU": 1.0})):
            grids[name] = tune.Tuner(
                where, param_space={"k": tune.grid_search([0, 1])},
                tune_config=tune.TuneConfig(metric="i", mode="max",
                                            max_concurrent_trials=2,
                                            trial_resources=res),
                run_config=RunConfig(name=f"where_{name}",
                                     storage_path=str(tmp_path))).fit()
        gpu = [r.metrics for r in grids["gpu"]]
        assert not grids["gpu"].errors and not grids["cpu"].errors
        assert len({m["pid"] for m in gpu}) == 2
        assert {m["node"] for m in gpu} == {gpu_node.node_id.hex()}
        assert all(m["visible"] != "" for m in gpu)
        assert all(r.metrics["visible"] == "" for r in grids["cpu"])
    finally:
        cluster.remove_node(gpu_node)
