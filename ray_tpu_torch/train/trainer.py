"""TorchTrainer — distributed data-parallel training driver: the port of
``ray_tpu/train/trainer.py``'s `JaxTrainer` (its SPMD path), on the
port's cluster runtime, under the name Ray gives its torch trainer.

Reference parity: TorchTrainer/DataParallelTrainer + BackendExecutor
(train/torch/torch_trainer.py:11, train/data_parallel_trainer.py:25,
train/_internal/backend_executor.py:69,142,458) with the v2 controller's
failure handling (train/v2/_internal/execution/controller.py:73) — no
Tune coupling in the fit path (the v2 design).

Flow: fit() creates a WorkerGroup of actors gang-placed in a PG, wires
rank/world env + the ``torch.distributed`` rendezvous (rank 0's TCP
store), starts the user train loop on every worker, then drives the
result loop — registering reported checkpoints (top-k) and restarting
the whole gang from the latest checkpoint on worker failure. Gang-level
restart is deliberate: one SPMD program spans all processes, so a
single lost process invalidates the whole world — elasticity is at gang
granularity.

Deviations from the JAX package:

- ``ScalingConfig.use_gpu`` (default True: the port runs on the card
  unless the caller asks for the CPU) in place of ``use_tpu``; a worker
  is one process with one device, so ``num_cpu_devices_per_worker``
  takes only None or 1.
- Every gang, world 1 included, joins a process group (``setup_torch``);
  ``RAY_TPU_TRAIN_COORDINATOR`` is still set only where JAX sets it
  (world > 1).
- No libtpu topology env (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``):
  the process group's rendezvous takes its place.
- ``strategy="pipeline"`` (the MPMD strategy,
  ``train/pipeline_strategy.py``) runs its stages on the card when
  ``ScalingConfig.use_gpu`` is set and on the CPU otherwise; its
  ``Result`` also carries the last step's per-stage stats
  (``stage_stats``: op spans, host copies, peak memory, launches).
- The loop travels by value only where the port's pickler sends it so
  (defined in ``__main__``, inside a function, or a lambda); a loop
  defined at the top of an importable module travels by reference, and
  the workers must be able to import that module.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

from ray_tpu_torch.core import serialization
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointConfig,
    CheckpointManager,
)
from ray_tpu_torch.train.worker_group import (
    RENDEZVOUS_TIMEOUT_S,
    WorkerGroup,
    WorkerGroupError,
)

# the result loop's polls (JAX's): one next_result call, and one round
POLL_TIMEOUT_S = 30.0
ROUND_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ScalingConfig:
    """Reference: ray.train.ScalingConfig (air/config.py). num_workers is
    the number of worker PROCESSES, one device each. Setting min_workers
    turns on ELASTIC sizing (reference: Train v2 ScalingPolicy,
    v2/_internal/execution/scaling_policy/scaling_policy.py:26): each
    gang (re)start sizes the world to what the cluster can place,
    within [min_workers, num_workers]."""

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: dict[str, float] | None = None
    placement_strategy: str = "PACK"
    # JAX's count of virtual CPU devices a worker exposes; a torch
    # process has one CPU device, so only None or 1
    num_cpu_devices_per_worker: int | None = None
    min_workers: int | None = None  # elastic floor (None = fixed size)
    # mid-run elastic: how often the result loop re-evaluates the
    # scaling decision against live capacity (reference: Train v2's
    # continuous ScalingPolicy, scaling_policy.py:26). 0 disables —
    # sizing then happens only at gang (re)starts.
    elastic_interval_s: float = 0.0

    def __post_init__(self):
        if self.num_cpu_devices_per_worker not in (None, 1):
            raise ValueError(
                f"num_cpu_devices_per_worker="
                f"{self.num_cpu_devices_per_worker}: a torch worker process "
                f"has one CPU device; run more workers instead")
        if (self.use_gpu and self.resources_per_worker is not None
                and not self.resources_per_worker.get("GPU", 0) > 0):
            raise ValueError(
                f"use_gpu=True but resources_per_worker="
                f"{self.resources_per_worker} claims no GPU; add a GPU "
                f"share or pass use_gpu=False")

    def decide_num_workers(self) -> int:
        """Elastic sizing decision against the live resource view."""
        if self.min_workers is None:
            return self.num_workers
        import ray_tpu_torch

        avail = ray_tpu_torch.available_resources()
        req = self.worker_resources()
        fit = self.num_workers
        for r, q in req.items():
            if q > 0:
                # epsilon guards float residue from fractional releases
                fit = min(fit, int((avail.get(r, 0.0) + 1e-9) // q))
        return max(self.min_workers, min(self.num_workers, fit))

    def extra_capacity(self) -> int:
        """How many MORE workers the cluster could place right now (the
        running gang's own resources are already subtracted from the
        availability view)."""
        import ray_tpu_torch

        avail = ray_tpu_torch.available_resources()
        fit = 1 << 30
        for r, q in self.worker_resources().items():
            if q > 0:
                fit = min(fit, int((avail.get(r, 0.0) + 1e-9) // q))
        return max(0, fit)

    def worker_resources(self) -> dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"CPU": 1.0, "GPU": 1.0} if self.use_gpu else {"CPU": 1.0}


@dataclasses.dataclass
class FailureConfig:
    """Reference: ray.train.FailureConfig — max_failures gang restarts."""

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    """Reference: ray.train.RunConfig (air/config.py)."""

    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig | None = None
    checkpoint_config: CheckpointConfig | None = None
    # Tune stop criteria: {"metric": threshold} — a trial terminates when
    # any named metric reaches its threshold (reference: air/config.py
    # RunConfig.stop)
    stop: dict | None = None


@dataclasses.dataclass
class Result:
    """Reference: ray.train.Result."""

    metrics: dict
    checkpoint: Checkpoint | None
    path: str
    error: BaseException | None = None
    metrics_history: list = dataclasses.field(default_factory=list)
    # strategy="pipeline": the last step's per-stage stats
    # (`PipelineStrategy.last_stage_stats`)
    stage_stats: list | None = None


class TrainingFailedError(RuntimeError):
    pass


class TorchTrainer:
    """Run `train_loop_per_worker` on a gang of workers.

    The loop uses the session API (ray_tpu_torch.train.report /
    get_context / get_checkpoint); inside it, build a mesh with
    ``build_mesh`` — ``torch.distributed`` is already initialised
    across the gang by the time the loop runs (NCCL on the card, gloo
    on the CPU)."""

    def __init__(
        self,
        train_loop_per_worker: Callable | None = None,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        resume_from_checkpoint: Checkpoint | None = None,
        datasets: dict | None = None,
        strategy: str = "spmd",
    ):
        if strategy not in ("spmd", "pipeline"):
            raise ValueError(f"unknown train strategy {strategy!r} "
                             "(spmd | pipeline)")
        if strategy == "spmd" and train_loop_per_worker is None:
            raise ValueError("spmd strategy needs train_loop_per_worker")
        self._fn = train_loop_per_worker
        self._config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._resume = resume_from_checkpoint
        self.strategy = strategy
        # name -> ray_tpu_torch.data.Dataset, split across the gang at
        # start (reference: DataParallelTrainer datasets= +
        # get_dataset_shard)
        self._datasets = datasets or {}

    # ------------------------------------------------------------------

    def fit(self) -> Result:
        if self.strategy == "pipeline":
            return self._fit_pipeline()
        return self._fit_spmd()

    def _fit_pipeline(self) -> Result:
        """Pipeline-parallel fit: stages on worker subsets, the 1F1B
        schedule per step (train/pipeline_strategy.py). Config keys in
        train_loop_config: `model` (PipelinedConfig kwargs), `batch`
        ({tokens, targets} numpy), `steps`, `num_stages` (default:
        scaling_config.num_workers), `num_microbatches`, `lr`, `seed`,
        plus the interleaved/ZeRO composition knobs `num_repeats`,
        `zero_stage`, `data_parallel`, `momentum`. Stage workers
        checkpoint their param shards through the CheckpointManager
        every `checkpoint_frequency` steps (the manager reassembles a
        restore-compatible full state via
        `load_pipeline_checkpoint`). The stages run on the card when
        ``scaling_config.use_gpu`` is set, else on the CPU."""
        from ray_tpu_torch.train.pipeline_strategy import PipelineStrategy

        cfg = dict(self._config or {})
        if "batch" not in cfg:
            raise ValueError("pipeline strategy needs "
                             "train_loop_config['batch']")
        name = self.run_config.name or f"pipeline_{int(time.time())}"
        storage = self.run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        exp_dir = os.path.join(storage, name)
        os.makedirs(exp_dir, exist_ok=True)
        ckpt_cfg = (self.run_config.checkpoint_config
                    or CheckpointConfig())
        manager = CheckpointManager(exp_dir, ckpt_cfg)
        sc = self.scaling_config
        ps = PipelineStrategy(
            cfg.get("model") or {},
            num_stages=cfg.get("num_stages", sc.num_workers),
            num_microbatches=cfg.get("num_microbatches"),
            lr=cfg.get("lr", 1e-2),
            seed=cfg.get("seed", 0),
            resources_per_worker=sc.resources_per_worker,
            placement_strategy=sc.placement_strategy,
            num_repeats=int(cfg.get("num_repeats", 1)),
            zero_stage=int(cfg.get("zero_stage", 0)),
            data_parallel=int(cfg.get("data_parallel", 1)),
            momentum=float(cfg.get("momentum", 0.0)),
            device="cuda" if sc.use_gpu else "cpu",
        )
        from ray_tpu_torch import dashboard as _dash

        history: list[dict] = []
        last_ckpt: Checkpoint | None = None
        try:
            steps = int(cfg.get("steps", 1))
            freq = max(1, int(ckpt_cfg.checkpoint_frequency or 1))
            for step in range(steps):
                metrics = ps.train_step(cfg["batch"])
                metrics["step"] = step
                history.append(metrics)
                if (step + 1) % freq == 0 or step == steps - 1:
                    staged = ps.save_checkpoint(
                        os.path.join(exp_dir, f"staging_{step:06d}"))
                    last_ckpt = manager.register(staged, metrics)
                _dash.publish_view("train", name, {
                    "status": "RUNNING", "iteration": len(history),
                    "num_workers": ps.num_stages, "metrics": metrics})
            _dash.publish_view("train", name, {
                "status": "FINISHED", "iteration": len(history),
                "num_workers": ps.num_stages,
                "metrics": history[-1] if history else {}})
        except BaseException as e:
            # a dead view must not read RUNNING forever
            _dash.publish_view("train", name, {
                "status": "FAILED", "iteration": len(history),
                "error": str(e)})
            raise
        finally:
            ps.shutdown()
        return Result(metrics=history[-1] if history else {},
                      checkpoint=last_ckpt, path=exp_dir,
                      metrics_history=history,
                      stage_stats=ps.last_stage_stats)

    def _fit_spmd(self) -> Result:
        name = self.run_config.name or f"torch_trainer_{int(time.time())}"
        storage = self.run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        exp_dir = os.path.join(storage, name)
        os.makedirs(exp_dir, exist_ok=True)
        manager = CheckpointManager(
            exp_dir, self.run_config.checkpoint_config or CheckpointConfig())
        failure_config = self.run_config.failure_config or FailureConfig()

        resume = self._resume or manager.latest()
        resize_to = None
        failures = 0
        history: list[dict] = []
        from ray_tpu_torch import dashboard as _dash

        _dash.publish_view("train", name, {
            "status": "RUNNING", "iteration": 0,
            "num_workers": self.scaling_config.num_workers})
        while True:
            wg = None
            try:
                target, resize_to = resize_to, None  # one-shot: a FAILED
                # resized start must not retry the stale target forever
                wg = self._start_worker_group(name, exp_dir, resume, target)
                metrics, ckpt = self._result_loop(wg, manager, history,
                                                  run_name=name)
                _dash.publish_view("train", name, {
                    "status": "FINISHED", "iteration": len(history),
                    "num_workers": wg.num_workers, "metrics": metrics})
                return Result(metrics=metrics, checkpoint=ckpt or
                              manager.latest(), path=exp_dir,
                              metrics_history=history)
            except _ElasticResize as e:
                # mid-run scaling decision: controlled gang restart from
                # the latest checkpoint at a result boundary (does not
                # consume the failure budget — reference: Train v2
                # ScalingPolicy resize decisions, scaling_policy.py:26).
                # The TARGET rides along: the availability view right
                # after shutdown is stale (old workers still releasing),
                # so re-deciding from it would undo the resize.
                resume = manager.latest()
                resize_to = e.target
            except (WorkerGroupError, _WorkerFailure) as e:
                failures += 1
                if failures > failure_config.max_failures:
                    _dash.publish_view("train", name, {
                        "status": "FAILED", "iteration": len(history),
                        "error": str(e)})
                    raise TrainingFailedError(
                        f"training failed after {failures - 1} restarts: {e}"
                    ) from e
                resume = manager.latest()  # gang restart from latest ckpt
            finally:
                if wg is not None:
                    wg.shutdown()

    # ------------------------------------------------------------------

    def _start_worker_group(self, name: str, exp_dir: str,
                            resume: Checkpoint | None,
                            num_override: int | None = None) -> WorkerGroup:
        import ray_tpu_torch

        sc = self.scaling_config
        n_workers = num_override or sc.decide_num_workers()
        res = sc.worker_resources()
        wg = WorkerGroup(
            num_workers=n_workers,
            resources_per_worker=res,
            placement_strategy=sc.placement_strategy,
        )
        try:
            infos = wg.execute("node_info")
            coordinator = f"{infos[0]['ip']}:{infos[0]['port']}"
            # rank/world env (reference: _create_rank_world_size_mappings,
            # backend_executor.py:376) + local ranks grouped by node
            by_node: dict[str, list[int]] = {}
            for rank, info in enumerate(infos):
                by_node.setdefault(info["node_id"], []).append(rank)
            node_order = list(by_node)
            for rank, info in enumerate(infos):
                node_id = info["node_id"]
                env = {
                    "RAY_TPU_TRAIN_RANK": rank,
                    "RAY_TPU_TRAIN_WORLD_SIZE": wg.num_workers,
                    "RAY_TPU_TRAIN_LOCAL_RANK": by_node[node_id].index(rank),
                    "RAY_TPU_TRAIN_NODE_RANK": node_order.index(node_id),
                }
                if wg.num_workers > 1:
                    env["RAY_TPU_TRAIN_COORDINATOR"] = coordinator
                wg.execute_single(rank, "setup_env", env)
            # torch.distributed rendezvous: all workers join concurrently
            # (init_process_group blocks until the world is complete)
            device = "cuda" if res.get("GPU", 0) > 0 else "cpu"
            refs = [w.setup_torch.remote(f"tcp://{coordinator}",
                                         wg.num_workers, rank, device)
                    for rank, w in enumerate(wg.workers)]
            ray_tpu_torch.get(refs, timeout=RENDEZVOUS_TIMEOUT_S)
            fn_blob = serialization.dumps_fn(self._fn)
            for rank, info in enumerate(infos):
                node_id = info["node_id"]
                ctx = dict(
                    world_size=wg.num_workers,
                    world_rank=rank,
                    local_rank=by_node[node_id].index(rank),
                    local_world_size=len(by_node[node_id]),
                    node_rank=node_order.index(node_id),
                    experiment_name=name,
                    trial_dir=exp_dir,
                    coordinator_address=(coordinator if wg.num_workers > 1
                                         else None),
                )
                shards_blob = None
                if self._datasets:
                    shards_blob = serialization.dumps_fn({
                        dname: ds.shard(wg.num_workers, rank)
                        for dname, ds in self._datasets.items()})
                wg.execute_single(
                    rank, "start_training", fn_blob, self._config, ctx,
                    resume.path if resume else None, shards_blob)
            return wg
        except Exception as e:
            wg.shutdown()
            if isinstance(e, WorkerGroupError):
                raise
            raise WorkerGroupError(f"worker group bootstrap failed: {e}") \
                from e

    # ------------------------------------------------------------------

    def _result_loop(self, wg: WorkerGroup, manager: CheckpointManager,
                     history: list, run_name: str = ""
                     ) -> tuple[dict, Checkpoint | None]:
        """Drive rounds of per-worker reports until every worker finishes
        (reference: backend_executor.get_next_results — all workers must
        report in lockstep)."""
        from ray_tpu_torch.core import exceptions as exc

        last_metrics: dict = {}
        last_ckpt: Checkpoint | None = None
        finished: set[int] = set()
        sc = self.scaling_config
        next_elastic_check = (time.monotonic() + sc.elastic_interval_s
                              if sc.elastic_interval_s > 0 else None)
        while len(finished) < wg.num_workers:
            if next_elastic_check is not None and \
                    time.monotonic() >= next_elastic_check:
                next_elastic_check = time.monotonic() + sc.elastic_interval_s
                want = min(sc.num_workers,
                           wg.num_workers + sc.extra_capacity())
                if want > wg.num_workers and last_ckpt is not None:
                    # capacity appeared: grow the gang at a checkpointed
                    # boundary (shrink happens via the failure path when
                    # a worker is lost)
                    raise _ElasticResize(wg.num_workers, want)
            round_reports: dict[int, dict] = {}
            for rank in range(wg.num_workers):
                if rank in finished:
                    continue
                deadline = time.monotonic() + ROUND_TIMEOUT_S
                while True:
                    try:
                        r = wg.execute_single(rank, "next_result",
                                              timeout=POLL_TIMEOUT_S)
                    except exc.GetTimeoutError:
                        # slow (e.g. a first kernel build under load),
                        # not dead — keep polling until the round deadline
                        if time.monotonic() > deadline:
                            raise _WorkerFailure(
                                f"train worker {rank} unresponsive for "
                                f"{ROUND_TIMEOUT_S:.0f}s", rank) from None
                        continue
                    except (exc.ActorDiedError, exc.ActorUnavailableError,
                            exc.TaskError) as e:
                        raise _WorkerFailure(
                            f"train worker {rank} died: {e}", rank) from e
                    if r["status"] == "report":
                        round_reports[rank] = r
                        break
                    if r["status"] == "finished":
                        finished.add(rank)
                        break
                    if r["status"] == "error":
                        raise _WorkerFailure(
                            f"train loop failed on rank {rank}: "
                            f"{r['error']}\n{r.get('traceback', '')}", rank)
                    if time.monotonic() > deadline:
                        raise _WorkerFailure(
                            f"train worker {rank} produced no result in "
                            f"{ROUND_TIMEOUT_S:.0f}s", rank)
            rank0 = round_reports.get(0)
            if rank0 is not None:
                last_metrics = rank0["metrics"]
                history.append(dict(last_metrics))
                if rank0.get("checkpoint_dir"):
                    last_ckpt = manager.register(
                        Checkpoint(rank0["checkpoint_dir"]), last_metrics)
                if run_name:
                    from ray_tpu_torch import dashboard as _dash

                    _dash.publish_view("train", run_name, {
                        "status": "RUNNING",
                        "iteration": len(history),
                        "num_workers": wg.num_workers,
                        "metrics": last_metrics})
        return last_metrics, last_ckpt


class _WorkerFailure(RuntimeError):
    def __init__(self, msg, rank):
        super().__init__(msg)
        self.rank = rank


class _ElasticResize(Exception):
    def __init__(self, current: int, target: int):
        super().__init__(f"elastic resize {current} -> {target}")
        self.current = current
        self.target = target
