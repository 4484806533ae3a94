"""The port's Tune (ray_tpu_torch.tune: schedulers.py, tuner.py) on the
local runtime, against the JAX package's:

- FIFO, ASHA, median stopping, PBT, PB2 and the resource-changing
  wrapper fed the same synthetic result stream (seeded, interleaved
  across trials, exploits applied or aborted in turn) as their JAX
  counterparts: every decision identical, PB2's GP-chosen configs
  included;
- the sweep, grid, ASHA and restore scenarios of tests/test_tune.py on
  both packages in local mode at max_concurrent_trials=1: the same
  configs and the same results (exactly, where the trainable is
  deterministic), and for ASHA the same trials finished and cut;
- ASHA with eight trials at once on the port: level 1.0 finishes at 30
  and every other trial is cut, which holds only if each trial reports
  into its own session (the JAX Tuner's module-global session mixes
  them in local mode);
- a PBT exploit that restarts a trial from a cloned checkpoint;
- a 2-trial GPT-2-tiny sweep that checkpoints its train state with
  `save_train_state`, then a `Tuner.restore` of one trial marked
  RUNNING: the restored trial resumes from its checkpoint through
  `tune.get_checkpoint` and `load_train_state`, and its losses after
  the resume are bitwise equal to the first run's;
- the launch counter under eight threads adding at once.

The trainables take the package's name, so one function serves both
sides."""

import dataclasses
import functools
import importlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.tune import schedulers as jax_sched
from ray_tpu_torch.tune import schedulers as port_sched

RUNTIMES = {"jax": ray_tpu, "port": ray_tpu_torch}
TUNE = {"jax": "ray_tpu.tune", "port": "ray_tpu_torch.tune"}
RUN_CONFIG = {"jax": "ray_tpu.train.trainer",
              "port": "ray_tpu_torch.train.trainer"}


# ------------------------------------------------------------ schedulers


def _stream(seed: int, n_trials: int = 6, steps: int = 16):
    """(trial_id, config, per-step losses) and a seeded interleaving of
    their reports."""
    rng = np.random.RandomState(seed)
    trials = []
    for i in range(n_trials):
        cfg = {"lr": float(rng.choice([0.01, 0.05, 0.1, 0.3, 0.6])),
               "wd": float(rng.uniform(0.0, 0.1)), "layers": int(
                   rng.randint(1, 5))}
        trials.append((f"trial_{i:05d}", cfg))
    order = []
    pending = {tid: 0 for tid, _ in trials}
    while pending:
        tid = sorted(pending)[rng.randint(len(pending))]
        pending[tid] += 1
        order.append(tid)
        if pending[tid] == steps:
            del pending[tid]
    noise = rng.normal(scale=0.01, size=len(order))
    return trials, order, noise


def _drive(sched, seed: int) -> list:
    """Feed `sched` the stream; returns every decision in order. A
    stopped trial reports no more; an exploit or a reallocation is
    applied and aborted in turn, as the Tuner does when the source has
    a checkpoint or has not."""
    trials, order, noise = _stream(seed)
    if hasattr(sched, "set_objective"):
        sched.set_objective("loss", "min")
    configs = dict(trials)
    t = {tid: 0 for tid in configs}
    for tid, cfg in trials:
        if hasattr(sched, "on_trial_add"):
            sched.on_trial_add(tid, cfg)
    out, stopped, turn = [], set(), 0
    for tid, eps in zip(order, noise):
        if tid in stopped:
            continue
        t[tid] += 1
        cfg = configs[tid]
        loss = 1.0 / (1.0 + cfg["lr"] * t[tid]) + cfg["wd"] + float(eps)
        d = sched.on_result(tid, {"training_iteration": t[tid],
                                  "loss": loss})
        out.append((tid, t[tid], d))
        if d == "STOP":
            stopped.add(tid)
            sched.on_trial_complete(tid)
        elif isinstance(d, tuple):
            turn += 1
            applied = turn % 2 == 1
            if d[0] == "EXPLOIT":
                if applied:
                    configs[tid] = dict(d[2])
                    sched.on_exploit_applied(tid)
                else:
                    sched.on_exploit_aborted(tid)
            elif not applied:
                sched.on_realloc_aborted(tid)
    for tid in configs:
        if tid not in stopped:
            sched.on_trial_complete(tid)
    return out


def _asha(mod):
    return mod.ASHAScheduler(metric="loss", mode="min", max_t=16,
                             grace_period=2, reduction_factor=2)


SCHEDULERS = {
    "fifo": lambda mod: mod.FIFOScheduler(),
    "asha": _asha,
    "asha_max_mode": lambda mod: mod.ASHAScheduler(
        metric="loss", mode="max", max_t=12, grace_period=1,
        reduction_factor=3),
    "median": lambda mod: mod.MedianStoppingRule(
        metric="loss", mode="min", grace_period=3, min_samples_required=2),
    "pbt": lambda mod: mod.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.05, 0.1, 0.5], "wd": "perturb",
                              "layers": "perturb"},
        quantile_fraction=0.34, seed=3),
    "pb2": lambda mod: mod.PB2(
        metric="loss", mode="min", perturbation_interval=3,
        hyperparam_bounds={"lr": (0.01, 1.0), "wd": (0.0, 0.1),
                           "layers": (1, 8)}, quantile_fraction=0.34,
        seed=5),
    "resource_changing": lambda mod: mod.ResourceChangingScheduler(
        base_scheduler=_asha(mod), reallocation_interval=3, metric="loss",
        mode="min"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match_jax(name):
    for seed in (0, 1):
        want = _drive(SCHEDULERS[name](jax_sched), seed)
        got = _drive(SCHEDULERS[name](port_sched), seed)
        assert got == want
    kinds = {d if isinstance(d, str) else d[0] for _, _, d in got}
    expect = {"fifo": {"CONTINUE"}, "pbt": {"CONTINUE", "EXPLOIT"},
              "pb2": {"CONTINUE", "EXPLOIT"},
              "resource_changing": {"CONTINUE", "STOP", "REALLOCATE"}
              }.get(name, {"CONTINUE", "STOP"})
    assert kinds == expect, kinds


# ------------------------------------------------------------ Tuner


@pytest.fixture
def runtimes():
    for ray in RUNTIMES.values():
        ray.init(local_mode=True, num_cpus=8)
    yield RUNTIMES
    for ray in RUNTIMES.values():
        ray.shutdown()


def _quadratic(pkg, config):
    # minimum at x=3; lr controls convergence speed
    tune = importlib.import_module(TUNE[pkg])
    x = 0.0
    for _ in range(20):
        x -= config["lr"] * 2 * (x - 3.0)
        tune.report({"objective": (x - 3.0) ** 2, "x": x})


def _slow_loss(pkg, config):
    tune = importlib.import_module(TUNE[pkg])
    for i in range(30):
        tune.report({"loss": config["level"] + 0.001 * i})


def _tuner(pkg, fn, root, name, param_space, **tune_config):
    tune = importlib.import_module(TUNE[pkg])
    run_config = importlib.import_module(RUN_CONFIG[pkg]).RunConfig
    sched = tune_config.pop("scheduler", None)
    return tune.Tuner(
        functools.partial(fn, pkg), param_space=param_space(tune),
        tune_config=tune.TuneConfig(
            scheduler=sched(tune) if sched else None, **tune_config),
        run_config=run_config(name=name, storage_path=str(root / pkg)))


def _summary(grid, keys):
    return sorted((r.trial_id, tuple(sorted(r.config.items())),
                   tuple(r.metrics.get(k) for k in keys), r.error)
                  for r in grid)


def _sweep(pkg, root):
    grid = _tuner(pkg, _quadratic, root, "sweep20",
                  lambda tune: {"lr": tune.loguniform(1e-3, 0.5)},
                  metric="objective", mode="min", num_samples=20, seed=7,
                  max_concurrent_trials=1).fit()
    best = grid.get_best_result()
    assert len(grid) == 20 and not grid.errors
    assert best.metrics["objective"] < 0.5 and best.config["lr"] > 0.01
    return _summary(grid, ("objective", "x", "training_iteration")), \
        best.trial_id


def _grid(pkg, root):
    grid = _tuner(pkg, _quadratic, root, "grid",
                  lambda tune: {"lr": tune.grid_search([0.01, 0.1, 0.4])},
                  metric="objective", mode="min",
                  max_concurrent_trials=1).fit()
    assert sorted(r.config["lr"] for r in grid) == [0.01, 0.1, 0.4]
    return _summary(grid, ("objective", "x", "training_iteration"))


def _asha_sweep(pkg, root, concurrent=1, name="asha"):
    grid = _tuner(pkg, _slow_loss, root, name,
                  lambda tune: {"level": tune.grid_search(
                      [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])},
                  metric="loss", mode="min",
                  max_concurrent_trials=concurrent,
                  scheduler=lambda tune: tune.ASHAScheduler(
                      max_t=30, grace_period=5, reduction_factor=2)).fit()
    its = {r.config["level"]: r.metrics.get("training_iteration", 0)
           for r in grid}
    return {level: "finished" if it == 30 else "cut"
            for level, it in its.items()}, its


def _restore(pkg, root):
    tune = importlib.import_module(TUNE[pkg])
    grid = _tuner(pkg, _quadratic, root, "resume",
                  lambda tune: {"lr": tune.grid_search([0.05, 0.2])},
                  metric="objective", mode="min",
                  max_concurrent_trials=1).fit()
    first = _summary(grid, ("objective", "x"))
    state_file = root / pkg / "resume" / "tuner_state.json"
    state = json.loads(state_file.read_text())
    state["trials"][1]["status"] = "RUNNING"  # as if it died mid-flight
    state_file.write_text(json.dumps(state))
    grid2 = tune.Tuner.restore(str(root / pkg / "resume"),
                               functools.partial(_quadratic, pkg)).fit()
    assert len(grid2) == 2 and not grid2.errors
    assert all(r.metrics for r in grid2)
    return first, _summary(grid2, ("objective", "x"))


@pytest.mark.parametrize("scenario", [_sweep, _grid, _restore],
                         ids=["sweep", "grid", "restore"])
def test_tuner_matches_jax(runtimes, tmp_path, scenario):
    want = scenario("jax", tmp_path)
    got = scenario("port", tmp_path)
    assert got == want


def test_asha_matches_jax_one_at_a_time(runtimes, tmp_path):
    want, want_its = _asha_sweep("jax", tmp_path)
    got, got_its = _asha_sweep("port", tmp_path)
    assert got == want
    assert got == {level: "finished" if level == 1.0 else "cut"
                   for level in got}
    assert all(5 <= got_its[lv] < 30 for lv in got if lv != 1.0)


def test_concurrent_trials_keep_their_own_sessions(runtimes, tmp_path):
    """Eight trials at once: every report lands in its own trial's
    session, so ASHA sees each level's own losses. Level 1.0 reaches
    max_t and every other level is cut."""
    got, its = _asha_sweep("port", tmp_path, concurrent=8,
                           name="asha8")
    assert got == {level: "finished" if level == 1.0 else "cut"
                   for level in got}, its


def test_sessions_are_bound_to_the_trial_thread():
    """Two trial actors made one after the other (the second would take
    over a module-global session): each trainable's reports reach its
    own actor, and outside a trial report raises."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.tuner import TrialActor

    go = threading.Event()

    def trainable(config):
        go.wait(10)
        for i in range(3):
            tune.report({"who": config["who"], "i": i})

    a = TrialActor("a", trainable, {"who": "a"})
    b = TrialActor("b", trainable, {"who": "b"})
    go.set()
    seen = {"a": [], "b": []}
    for name, actor in (("a", a), ("b", b)):
        while True:
            r = actor.poll(timeout=5.0)
            seen[name] += [m["who"] for m in r["results"]]
            if r["done"]:
                break
        assert r["error"] is None
    assert seen == {"a": ["a"] * 3, "b": ["b"] * 3}
    with pytest.raises(RuntimeError, match="outside a trial"):
        tune.report({"x": 1})
    with pytest.raises(RuntimeError, match="outside a trial"):
        tune.get_checkpoint()


def _pbt_progress(config):
    """Score is accumulated progress x; an exploit clones x (the
    checkpoint), and `start` records where the trial (re)started."""
    import time as _t

    from ray_tpu_torch import tune

    state = tune.get_checkpoint() or {"x": 0.0}
    x = start = state["x"]
    for _ in range(24):
        x += config["lr"]
        tune.report({"score": x, "start": start}, checkpoint={"x": x})
        _t.sleep(0.03)


def test_pbt_exploit_clones_a_checkpoint(runtimes, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=6,
        hyperparam_mutations={"lr": [0.5, 1.0, 2.0]}, seed=3)
    grid = tune.Tuner(
        _pbt_progress,
        param_space={"lr": tune.grid_search([0.001, 0.002, 0.005, 1.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt, max_concurrent_trials=4),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
    ).fit()
    assert not grid.errors
    assert pbt.exploit_count >= 1
    cloned = [r for r in grid if r.metrics["start"] > 0]
    assert cloned, [r.metrics for r in grid]
    # a straggler that restarted from the leader's progress ends far
    # beyond what its own lr could reach in 24 steps (0.005 * 24)
    assert all(r.metrics["score"] > 1.0 for r in cloned)
    assert os.path.exists(tmp_path / "pbt" / "tuner_state.json")


# ------------------------------------------------------------ GPT-2 sweep


def _gpt2_trial(root, record, config):
    """GPT-2-tiny on one fixed batch; the train state is checkpointed
    with save_train_state at config["ckpt_at"] and resumed from
    tune.get_checkpoint()."""
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.checkpointing import (
        load_train_state,
        save_train_state,
    )

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.float32)
    tx = train.adamw(config["lr"], weight_decay=0.1)
    gen = torch.Generator().manual_seed(0)
    state = train.TrainState.create(gpt2.init_gpt2(gen, cfg, device="cpu"),
                                    tx)
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        state = load_train_state(ckpt.path, state)
    step = train.make_train_step(lambda p, b: gpt2.gpt2_loss(p, b, cfg),
                                 tx)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (2, 33)).astype(np.int64)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    while state.step < config["steps"]:
        state, m = step(state, batch)
        loss = float(m["loss"])
        record.append((config["lr"], state.step, loss, ckpt is not None))
        shipped = None
        if state.step in config["ckpt_at"]:
            d = os.path.join(root, f"lr{config['lr']}", f"{state.step}")
            save_train_state(state, d)
            shipped = train.Checkpoint(d)
        tune.report({"loss": loss, "step": state.step}, checkpoint=shipped)


def test_gpt2_tiny_sweep_resumes_bitwise(runtimes, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    record: list = []
    trainable = functools.partial(_gpt2_trial, str(tmp_path / "ckpt"),
                                  record)
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([1e-3, 3e-3]), "steps": 4,
                     "ckpt_at": [2]},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="gpt2", storage_path=str(tmp_path)),
    ).fit()
    assert not grid.errors and len(grid) == 2
    assert all(r.metrics["step"] == 4 for r in grid)
    first = {(lr, s): loss for lr, s, loss, _ in record}
    assert len(first) == 8
    for lr in (1e-3, 3e-3):
        assert first[(lr, 4)] < first[(lr, 1)]

    exp = tmp_path / "gpt2"
    state = json.loads((exp / "tuner_state.json").read_text())
    resumed = state["trials"][1]
    assert resumed["config"]["lr"] == 3e-3
    resumed["status"] = "RUNNING"  # as if it died after step 4
    (exp / "tuner_state.json").write_text(json.dumps(state))
    record.clear()
    grid2 = tune.Tuner.restore(str(exp), trainable).fit()
    assert not grid2.errors
    # only the interrupted trial ran again, from its step-2 checkpoint
    assert [(lr, s, r) for lr, s, _, r in record] == [
        (3e-3, 3, True), (3e-3, 4, True)]
    for lr, s, loss, _ in record:
        assert loss == first[(lr, s)], (s, loss, first[(lr, s)])


# ------------------------------------------------------------ counter


def test_launch_counter_is_thread_safe():
    """8 threads x 10,000 adds, with the interpreter switching threads
    as often as it can: no add is lost."""
    from ray_tpu_torch._build import LaunchCounter

    counter = LaunchCounter("stress")
    start = threading.Barrier(8)

    def adder():
        start.wait(10)
        for _ in range(10_000):
            counter.add("S=1")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=adder) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.count == 80_000
    assert counter.by_shape == {"S=1": 80_000}
    counter.reset()
    assert counter.count == 0 and counter.by_shape == {}
