"""The port's trainer and worker group (ray_tpu_torch.train: trainer.py,
worker_group.py) on the port's cluster runtime, on the CPU.

- Every scenario of tests/test_train_lib.py's trainer section and of
  tests/test_elastic_midrun.py runs through `TorchTrainer` with the JAX
  test's own inputs and assertions: single-worker reports, two
  workers' rank env, gang restart resuming from a checkpoint, the
  failure budget exhausted, elastic sizing to what is available,
  dataset ingestion sharded over two workers, and a gang growing
  mid-run when capacity appears (the JAX test adds a 1-CPU node to a
  1-CPU cluster; here the module cluster gets two nodes that alone
  carry a ``grow`` resource, added and removed by the test).
- ``strategy="pipeline"`` and ``num_cpu_devices_per_worker=4`` raise.
- The slice as a whole: GPT-2 tiny (f32) trains 3 steps through
  `TorchTrainer` with one worker and with two gloo workers splitting the
  global batch, from params the JAX package's ``init_gpt2(PRNGKey(0))``
  makes (through ``interop``); the JAX package takes the same 3 steps
  here through ``make_train_step`` and ``optax.adamw(1e-3)``. One and
  two workers agree within rtol=1e-4, atol=1e-5 (the JAX test's bar)
  and each with JAX within 1e-4 relative (the parity phase's bar).
- Unit parity with no cluster: ``ScalingConfig.decide_num_workers`` and
  ``extra_capacity`` against JAX's on the same resource views, and
  ``TrainWorker.next_result``'s statuses against JAX's on sessions fed
  the same reports, finish and error.

One module-scoped cluster: a head node of 8 CPUs (the JAX fixture's)
with 2 warm workers. Train loops are defined inside factories or tests
(qualnames with ``<locals>``), so they travel to the workers by value;
they name only importable modules. Every get and wait has a timeout.
"""

import dataclasses
import os
import threading
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu.parallel.mesh  # noqa: F401  (JAX params after this import)
import ray_tpu
import ray_tpu_torch as ray
from ray_tpu.train import trainer as jax_trainer
from ray_tpu.train import worker_group as jax_wg
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import serialization
from ray_tpu_torch.train import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.train import worker_group as port_wg


def _cpu(**kw) -> ScalingConfig:
    """A scaling config whose workers run on the CPU."""
    return ScalingConfig(use_gpu=False, **kw)


def _add_node(cluster, prestart: int, **kw):
    os.environ["RAY_TPU_PRESTART_WORKERS"] = str(prestart)
    try:
        return cluster.add_node(**kw)
    finally:
        os.environ.pop("RAY_TPU_PRESTART_WORKERS", None)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True)
    try:
        _add_node(c, 2, num_cpus=8)
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()


# ------------------------------------------------------------ the loops


def _simple_loop_fn():
    def simple_loop(config):
        import ray_tpu_torch.train as train

        ctx = train.get_context()
        for step in range(config["steps"]):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})
        return "done"

    return simple_loop


def _gpt2_loop_fn():
    def gpt2_loop(config):
        """GPT-2 tiny (f32) over however many ranks the gang has, from
        the params in ``config["params"]``, on the JAX loop's global
        batch (each rank keeps its rows)."""
        import dataclasses
        import os
        import time as _t

        import numpy as np
        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch.models.gpt2 import (
            GPT2Config,
            gpt2_loss,
            gpt2_partition_rules,
        )
        from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
        from ray_tpu_torch.train import checkpointing
        from ray_tpu_torch.train import session as S
        from ray_tpu_torch.train.spmd import (
            init_sharded_state,
            make_train_step,
        )
        from ray_tpu_torch.util import tree

        torch.set_num_threads(2)
        ctx = train.get_context()
        cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
        mesh = build_mesh(MeshSpec(data=-1), device="cpu")
        tx = train.adamw(1e-3)
        rules = gpt2_partition_rules()
        state = init_sharded_state(
            lambda: tree.tree_map(torch.clone, config["params"]), tx, mesh,
            rules)
        start_step = 0
        ck = train.get_checkpoint()
        if ck is not None:
            with ck.as_directory() as d:
                state = checkpointing.load_train_state(d, state)
            start_step = int(state.step)

        # deterministic GLOBAL batch, identical regardless of world layout
        B, T = 8, cfg.block_size
        rng = np.random.RandomState(0)
        toks = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int64))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                                  mesh=mesh, rules=rules)
        for step in range(start_step, config["steps"]):
            if config.get("crash_at") == step and \
                    ctx.get_world_rank() == 0 and ck is None:
                # let the driver drain queued reports first, so the
                # prior checkpoint is registered before this process dies
                deadline = _t.monotonic() + 30
                while not S.get_session().results.empty() and \
                        _t.monotonic() < deadline:
                    _t.sleep(0.05)
                _t.sleep(0.5)  # pop->register window
                os._exit(1)  # a host lost mid-run (first try only)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            ckpt = None
            if (step + 1) % config.get("ckpt_every", 10 ** 9) == 0 \
                    or step == config["steps"] - 1:
                # collective save: every rank calls in; rank 0 reports
                tmp = f"{ctx.get_trial_dir()}/pending_ckpt_{step}"
                checkpointing.save_train_state(state, tmp)
                if ctx.get_world_rank() == 0:
                    ckpt = train.Checkpoint(tmp)
            train.report({"loss": loss, "step": step}, checkpoint=ckpt)

    return gpt2_loop


@pytest.fixture(scope="module")
def gpt2_jax():
    """(JAX config, JAX params, the port's params from them)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jax_gpt2
    from ray_tpu_torch import interop

    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dtype=jnp.float32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, interop.params_from_jax(jp)


# ------------------------------------------------- test_train_lib.py


def test_single_worker_reports(cluster, tmp_path):
    trainer = TorchTrainer(
        _simple_loop_fn(),
        train_loop_config={"steps": 3},
        scaling_config=_cpu(num_workers=1),
        run_config=RunConfig(name="t1", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3
    assert result.metrics["world"] == 1


def test_two_workers_rank_env(cluster, tmp_path):
    def loop(config):
        import os

        import torch.distributed as dist

        import ray_tpu_torch.train as train

        ctx = train.get_context()
        train.report({
            "rank": ctx.get_world_rank(),
            "env_rank": int(os.environ["RAY_TPU_TRAIN_RANK"]),
            "world": int(os.environ["RAY_TPU_TRAIN_WORLD_SIZE"]),
            "coordinator": os.environ.get("RAY_TPU_TRAIN_COORDINATOR"),
            "pg": (dist.get_rank(), dist.get_world_size(),
                   dist.get_backend()),
        })

    trainer = TorchTrainer(
        loop,
        train_loop_config={},
        scaling_config=_cpu(num_workers=2),
        run_config=RunConfig(name="t2", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["rank"] == 0
    assert result.metrics["env_rank"] == 0
    assert result.metrics["world"] == 2
    # the port's rendezvous: rank 0 of a two-rank gloo group, whose
    # coordinator JAX sets only at world > 1
    assert tuple(result.metrics["pg"]) == (0, 2, "gloo")
    assert result.metrics["coordinator"]


def test_gang_restart_resumes_from_checkpoint(cluster, gpt2_jax, tmp_path):
    """Kill rank 0 mid-run; the gang restarts from the latest checkpoint
    and the loss curve continues."""
    trainer = TorchTrainer(
        _gpt2_loop_fn(),
        train_loop_config={"steps": 6, "ckpt_every": 2, "crash_at": 4,
                           "params": gpt2_jax[2]},
        scaling_config=_cpu(num_workers=1),
        run_config=RunConfig(
            name="restart", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(num_to_keep=2)),
    )
    result = trainer.fit()
    steps = [m["step"] for m in result.metrics_history]
    # crashed at step 4 (before reporting), resumed from ckpt@step 3
    assert steps[-1] == 5
    assert 4 in steps
    assert result.checkpoint is not None
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]


def test_failure_budget_exhausted(cluster, tmp_path):
    def always_fail(config):
        raise RuntimeError("boom")

    trainer = TorchTrainer(
        always_fail,
        train_loop_config={},
        scaling_config=_cpu(num_workers=1),
        run_config=RunConfig(name="fail", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    )
    with pytest.raises(TrainingFailedError, match="boom"):
        trainer.fit()


@pytest.mark.slow  # as the JAX test (tier-1 budget)
def test_elastic_scaling_sizes_to_available(cluster, tmp_path):
    """min_workers turns on elastic sizing: ask for 6, floor 1, on an
    8-CPU cluster with 1-CPU workers the gang sizes to what fits."""

    def loop(config):
        import ray_tpu_torch.train as train

        ctx = train.get_context()
        train.report({"world": ctx.get_world_size()})

    # occupy some CPUs so fewer than 6 fit
    @ray.remote(num_cpus=1)
    class Hog:
        def ping(self):
            return "ok"

    hogs = [Hog.remote() for _ in range(4)]
    for h in hogs:
        assert ray.get(h.ping.remote(), timeout=60) == "ok"
    time.sleep(1.2)  # heartbeat settles
    trainer = TorchTrainer(
        loop,
        train_loop_config={},
        scaling_config=_cpu(num_workers=6, min_workers=1),
        run_config=RunConfig(name="elastic", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    for h in hogs:
        ray.kill(h)
    assert 1 <= result.metrics["world"] <= 4


@pytest.mark.slow  # as the JAX test (tier-1 budget)
def test_dataset_ingestion_sharded(cluster, tmp_path):
    """TorchTrainer(datasets=...) ships per-worker Dataset shards;
    get_dataset_shard() streams them."""
    from ray_tpu_torch import data as rd

    ds = rd.range(64, parallelism=8).map(lambda x: x * 2)

    def loop(config):
        import numpy as np

        import ray_tpu_torch.train as train

        shard = train.get_dataset_shard("train")
        total, count = 0, 0
        for batch in shard.iter_batches(batch_size=8):
            total += int(np.sum(batch))
            count += len(batch)
        train.report({"total": total, "count": count})

    trainer = TorchTrainer(
        loop,
        train_loop_config={},
        scaling_config=_cpu(num_workers=2),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": ds},
    )
    result = trainer.fit()
    # rank0's shard: blocks 0,2,4,6 of range(64)*2
    assert result.metrics["count"] == 32
    expected_rank0 = sum(
        x * 2 for i in range(0, 8, 2) for x in range(i * 8, (i + 1) * 8))
    assert result.metrics["total"] == expected_rank0


# --------------------------------------------- test_elastic_midrun.py


@pytest.mark.slow  # as the JAX test (tier-1 budget)
def test_midrun_elastic_grows_gang(cluster, tmp_path):
    """A gang running at capacity 1 GROWS to 2 when a node joins mid-run
    (continuous scaling decision, not just start-time sizing)."""
    first = _add_node(cluster, 0, num_cpus=1, resources={"grow": 1.0})
    cluster.wait_for_nodes()
    added = [first]
    try:
        def loop(config):
            import os as _os
            import time as _t

            from ray_tpu_torch import train

            ctx = train.get_context()
            start = 0
            ck = train.get_checkpoint()
            if ck is not None:
                with ck.as_directory() as d:
                    with open(f"{d}/step") as f:
                        start = int(f.read())
            for step in range(start, 12):
                _t.sleep(0.5)
                ckpt = None
                if ctx.get_world_rank() == 0:
                    d = f"{ctx.get_trial_dir()}/ck{step}"
                    _os.makedirs(d, exist_ok=True)
                    with open(f"{d}/step", "w") as f:
                        f.write(str(step + 1))
                    ckpt = train.Checkpoint(d)
                train.report({"step": step,
                              "world": ctx.get_world_size()}, checkpoint=ckpt)

        trainer = TorchTrainer(
            loop,
            train_loop_config={},
            scaling_config=_cpu(
                num_workers=2, min_workers=1, elastic_interval_s=1.0,
                resources_per_worker={"CPU": 1.0, "grow": 1.0}),
            run_config=RunConfig(
                name="elastic_midrun", storage_path=str(tmp_path),
                checkpoint_config=CheckpointConfig(num_to_keep=3)),
        )

        def add_node_later():
            time.sleep(3.0)
            added.append(_add_node(cluster, 0, num_cpus=1,
                                   resources={"grow": 1.0}))

        grower = threading.Thread(target=add_node_later, daemon=True)
        grower.start()
        result = trainer.fit()
        grower.join(timeout=30)
        worlds = [m["world"] for m in result.metrics_history]
        assert worlds[0] == 1, worlds  # started at capacity
        assert worlds[-1] == 2, worlds  # grew mid-run after the join
        assert result.metrics_history[-1]["step"] == 11
    finally:
        for nl in added:
            cluster.remove_node(nl)


# ------------------------------------------------------ what waits


def test_pipeline_strategy_raises(tmp_path):
    trainer = TorchTrainer(
        None, strategy="pipeline",
        train_loop_config={"batch": {}},
        scaling_config=_cpu(num_workers=2),
        run_config=RunConfig(name="pipe", storage_path=str(tmp_path)))
    with pytest.raises(NotImplementedError,
                       match="train/pipeline_strategy.py"):
        trainer.fit()


def test_use_gpu_worker_without_a_card_fails(cluster, tmp_path,
                                            monkeypatch):
    """A use_gpu gang placed on a node with an asserted GPU whose worker
    sees no CUDA device (its inherited device list names none) fails its
    bootstrap, naming the claim: no run on the CPU, no gloo in NCCL's
    place."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    gpu_node = _add_node(cluster, 0, num_cpus=1, num_gpus=1)
    cluster.wait_for_nodes()
    try:
        trainer = TorchTrainer(
            _simple_loop_fn(), train_loop_config={"steps": 1},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="nocard", storage_path=str(tmp_path)))
        with pytest.raises(TrainingFailedError,
                           match="claimed a GPU but sees no CUDA device"):
            trainer.fit()
    finally:
        cluster.remove_node(gpu_node)


def test_cpu_devices_per_worker_raises():
    with pytest.raises(ValueError, match="one CPU device"):
        _cpu(num_workers=1, num_cpu_devices_per_worker=4)
    assert _cpu(num_cpu_devices_per_worker=1).worker_resources() == \
        {"CPU": 1.0}
    assert ScalingConfig().worker_resources() == {"CPU": 1.0, "GPU": 1.0}


def test_use_gpu_without_a_gpu_share_raises():
    """use_gpu with a per-worker claim that holds no GPU is refused at
    once, not run on the CPU over gloo."""
    for res in ({"CPU": 2.0}, {"CPU": 1.0, "GPU": 0.0}):
        with pytest.raises(ValueError, match="claims no GPU"):
            ScalingConfig(use_gpu=True, resources_per_worker=res)
    assert ScalingConfig(
        use_gpu=True, resources_per_worker={"CPU": 1.0, "GPU": 0.5}
    ).worker_resources() == {"CPU": 1.0, "GPU": 0.5}
    assert _cpu(resources_per_worker={"CPU": 2.0}).worker_resources() == \
        {"CPU": 2.0}


# ------------------------------------------------------ the slice, whole


def test_gpt2_loss_parity_1_vs_2_workers_and_jax(cluster, gpt2_jax,
                                                   tmp_path):
    """Same global batch + init => the same losses whether the gang has
    one rank or two gloo ranks, and the JAX package's losses on one
    device."""
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt2 as jax_gpt2
    from ray_tpu.train import spmd as jax_spmd

    jcfg, jp, params = gpt2_jax
    losses = {}
    for n_workers in (1, 2):
        trainer = TorchTrainer(
            _gpt2_loop_fn(),
            train_loop_config={"steps": 3, "params": params},
            scaling_config=_cpu(num_workers=n_workers),
            run_config=RunConfig(name=f"parity{n_workers}",
                                 storage_path=str(tmp_path)),
        )
        result = trainer.fit()
        losses[n_workers] = [m["loss"] for m in result.metrics_history]
    assert len(losses[1]) == len(losses[2]) == 3
    np.testing.assert_allclose(losses[1], losses[2], rtol=1e-4, atol=1e-5)

    B, T = 8, jcfg.block_size
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}
    tx = optax.adamw(1e-3)
    state = jax_spmd.TrainState.create(jp, tx)
    step = jax_spmd.make_train_step(
        lambda p, b: jax_gpt2.gpt2_loss(p, b, jcfg), tx, donate=False)
    want = []
    for _ in range(3):
        state, m = step(state, batch)
        want.append(float(m["loss"]))
    for n_workers in (1, 2):
        np.testing.assert_allclose(losses[n_workers], want, rtol=1e-4)
    assert want[-1] < want[0]


# ------------------------------------------------- unit parity, no cluster


_VIEWS = ({"CPU": 8.0}, {"CPU": 3.0}, {"CPU": 0.5}, {},
          {"CPU": 2.9999999999}, {"CPU": 8.0, "ACC": 2.0},
          {"CPU": 8.0, "ACC": 0.5}, {"CPU": 1.0, "ACC": 7.0})
_SCALINGS = (dict(num_workers=4), dict(num_workers=6, min_workers=1),
             dict(num_workers=6, min_workers=2),
             dict(num_workers=3, min_workers=1, accelerator=True),
             dict(num_workers=4, min_workers=1,
                  resources_per_worker={"CPU": 2.0}),
             dict(num_workers=4, min_workers=1,
                  resources_per_worker={"CPU": 0.5, "ACC": 0.25}))


def _view(view: dict, acc: str) -> dict:
    return {(acc if k == "ACC" else k): v for k, v in view.items()}


@pytest.mark.parametrize("kw", _SCALINGS)
def test_scaling_decisions_match_jax(monkeypatch, kw):
    """decide_num_workers and extra_capacity on the same resource views
    (JAX's TPU where the port has GPU)."""
    kw = dict(kw)
    acc_on = kw.pop("accelerator", False)
    res = kw.pop("resources_per_worker", None)
    jsc = jax_trainer.ScalingConfig(
        use_tpu=acc_on, resources_per_worker=res and _view(res, "TPU"), **kw)
    psc = ScalingConfig(
        use_gpu=acc_on, resources_per_worker=res and _view(res, "GPU"), **kw)
    for view in _VIEWS:
        monkeypatch.setattr(ray_tpu, "available_resources",
                            lambda v=view: _view(v, "TPU"))
        monkeypatch.setattr(ray, "available_resources",
                            lambda v=view: _view(v, "GPU"))
        assert psc.decide_num_workers() == jsc.decide_num_workers(), view
        assert psc.extra_capacity() == jsc.extra_capacity(), view
    assert {("TPU" if k == "GPU" else k): v for k, v in
            psc.worker_resources().items()} == jsc.worker_resources()


def _statuses(worker, blob: bytes, config) -> list:
    """next_result's answers from first call to the end of the loop."""
    out = [worker.next_result(timeout=0.1)]
    ctx = dict(world_size=1, world_rank=0, local_rank=0, local_world_size=1,
               node_rank=0, experiment_name="e", trial_dir="/nonexistent",
               coordinator_address=None)
    worker.start_training(blob, config, ctx, None)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        r = worker.next_result(timeout=1.0)
        if r["status"] == "running":
            continue
        r.pop("traceback", None)
        out.append(r)
        if r["status"] in ("finished", "error"):
            return out
    raise AssertionError(f"no end within 30 s: {out}")


def _reporting_loop_fn(train):
    """The same loop for either package's `train` module."""
    def reporting_loop(config):
        for i in range(config["n"]):
            train.report({"i": i, "x": i * 0.5})
        if config.get("boom"):
            raise ValueError("boom at the end")
        return {"done": config["n"]}

    return reporting_loop


@pytest.mark.parametrize("config", ({"n": 3}, {"n": 0}, {"n": 2, "boom": 1}))
def test_next_result_statuses_match_jax(config):
    """The same reports, finish and error, seen through both packages'
    TrainWorker.next_result."""
    import ray_tpu.train as jax_train
    import ray_tpu_torch.train as port_train

    want = _statuses(jax_wg.TrainWorker(0, 1),
                     cloudpickle.dumps(_reporting_loop_fn(jax_train)),
                     config)
    got = _statuses(port_wg.TrainWorker(0, 1), serialization.dumps_fn(
        _reporting_loop_fn(port_train)), config)
    assert got == want
