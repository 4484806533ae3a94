"""Tuner — experiment driver over trial actors.

Reference parity: ray.tune.Tuner (tune/tuner.py:44, fit :344) driving the
TuneController event loop (tune/execution/tune_controller.py:68, step
:666): trials are actors; the controller starts up to the concurrency
limit, polls reports, consults the scheduler (ASHA early stopping), and
persists experiment state so `Tuner.restore` can finish interrupted
sweeps. Trials run as actors on the task/actor runtime (in the JAX
package each can itself be a trainer's fit, how Train rides Tune in the
reference, base_trainer.py:577-623; the port's trainer waits for the
cluster runtime).

The port's copy of ``ray_tpu/tune/tuner.py``, on the port's local
runtime (``ray_tpu_torch.init(local_mode=True)``), with two deviations:

- Checkpoint blobs (what a trainable reports with ``checkpoint=``) are
  written with the standard `pickle`, not cloudpickle. The trainable is
  handed to each `TrialActor` as an object: the local runtime passes
  arguments within the process, so nothing else is pickled. A trainable
  that only cloudpickle could ship would fail only under the cluster
  runtime, which is not ported.
- The trial session is bound to the trial's thread, not held in one
  module global: `report` and `get_checkpoint`, called from the thread
  that runs the trainable, find that trial's own session, so trials
  running at once in one process keep their results apart.

A PBT exploit or a resize stops the trial before killing its actor: in
one process a killed actor's trainable thread would run on.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import pickle
import queue
import threading
import time
import traceback
from typing import Any, Callable

from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants

# ---------------------------------------------------------------- session

# each trial thread's own _TrialSession, set where the thread starts
_thread_session = threading.local()


def _current_session() -> "_TrialSession | None":
    return getattr(_thread_session, "session", None)


class _TrialSession:
    def __init__(self, restored_checkpoint=None):
        # small bound keeps fast trainables in rough lockstep with the
        # controller so scheduler decisions (ASHA cuts, PBT exploits)
        # apply mid-flight instead of after the trial already finished
        self.results: queue.Queue = queue.Queue(maxsize=2)
        self.iteration = 0
        self.stopped = threading.Event()
        self.restored_checkpoint = restored_checkpoint
        self.latest_checkpoint = None
        self.ckpt_lock = threading.Lock()

    def report(self, metrics: dict, checkpoint=None):
        if self.stopped.is_set():
            raise _StopTrial()
        self.iteration += 1
        m = dict(metrics)
        m.setdefault("training_iteration", self.iteration)
        if checkpoint is not None:
            # PBT exploit clones this state into another trial
            # (reference: pbt.py _exploit via trial checkpoints)
            with self.ckpt_lock:
                self.latest_checkpoint = pickle.dumps(checkpoint)
        while True:
            try:
                self.results.put(m, timeout=0.1)
                break
            except queue.Full:
                if self.stopped.is_set():
                    raise _StopTrial() from None


class _StopTrial(BaseException):
    """Raised inside the trainable to unwind when the scheduler stops the
    trial (BaseException so bare `except Exception` in user code doesn't
    swallow it — reference uses the session's StopIteration channel)."""


def report(metrics: dict, checkpoint=None, **kwargs):
    """ray_tpu_torch.tune.report — inside a trainable, on the thread that
    runs it. `checkpoint` may be any picklable state; PBT clones it into
    exploited trials."""
    session = _current_session()
    if session is None:
        raise RuntimeError("tune.report() outside a trial")
    session.report(metrics, checkpoint=checkpoint)


def get_checkpoint():
    """Inside a trainable: the checkpoint this trial was (re)started from
    (None on a fresh start; set after a PBT exploit or restore)."""
    session = _current_session()
    if session is None:
        raise RuntimeError("tune.get_checkpoint() outside a trial")
    return session.restored_checkpoint


class TrialActor:
    """Hosts one trial: runs the trainable on a thread, serves polling."""

    def __init__(self, trial_id: str, fn: Callable, config: dict,
                 ckpt_blob: bytes | None = None):
        self.trial_id = trial_id
        restored = pickle.loads(ckpt_blob) if ckpt_blob else None
        self.session = _TrialSession(restored_checkpoint=restored)
        self.error: str | None = None
        self.finished = threading.Event()

        def run():
            _thread_session.session = self.session
            try:
                fn(config)
            except _StopTrial:
                pass
            except BaseException as e:  # noqa: BLE001
                self.error = "".join(traceback.format_exception(e))
            finally:
                self.finished.set()

        threading.Thread(target=run, daemon=True,
                         name=f"trial-{trial_id}").start()

    def poll(self, timeout: float = 2.0) -> dict:
        out = []
        deadline = time.monotonic() + timeout
        while True:
            try:
                out.append(self.session.results.get_nowait())
            except queue.Empty:
                if out or self.finished.is_set():
                    break
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.02)
        done = self.finished.is_set() and self.session.results.empty()
        with self.session.ckpt_lock:
            ckpt = self.session.latest_checkpoint
            self.session.latest_checkpoint = None  # ship each blob once
        return {"results": out, "done": done, "error": self.error,
                "checkpoint": ckpt}

    def stop(self):
        self.session.stopped.set()
        return True


# ---------------------------------------------------------------- trials


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"
    STOPPED = "STOPPED"  # by scheduler

    def __init__(self, trial_id: str, config: dict):
        self.trial_id = trial_id
        self.config = config
        self.status = Trial.PENDING
        self.last_result: dict = {}
        self.error: str | None = None
        self.actor = None

    def to_json(self) -> dict:
        return {"trial_id": self.trial_id, "config": _json_safe(self.config),
                "status": self.status, "last_result": _json_safe(self.last_result),
                "error": self.error}


@dataclasses.dataclass
class TuneConfig:
    """Reference: ray.tune.TuneConfig."""

    metric: str | None = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    scheduler: Any = None
    search_alg: Any = None  # a tune.search.Searcher (e.g. TPESearcher)
    seed: int | None = None
    trial_resources: dict[str, float] | None = None


@dataclasses.dataclass
class TuneResult:
    trial_id: str
    config: dict
    metrics: dict
    error: str | None = None


class ResultGrid:
    """Reference: ray.tune.ResultGrid."""

    def __init__(self, results: list[TuneResult], metric, mode):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self):
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: str | None = None,
                        mode: str | None = None) -> TuneResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results
                  if r.error is None and metric in r.metrics]
        if not scored:
            raise ValueError("no successful trial reported "
                             f"metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        rows = [{"trial_id": r.trial_id, **r.metrics,
                 **{f"config/{k}": v for k, v in r.config.items()}}
                for r in self._results]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows


# ------------------------------------------------- trainable adapters


def _stop_met(stop: dict | None, result: dict) -> bool:
    """Reference: ray.tune run(stop={...}) — stop when any named metric
    reaches its threshold."""
    if not stop:
        return False
    for k, v in stop.items():
        r = result.get(k)
        if r is not None and r >= v:
            return True
    return False


def _class_trainable_fn(cls, ckpt_every: int = 1):
    """Drive a Trainable subclass as a function trial: loop train(),
    ship full state as the checkpoint each iteration, resume from the
    session checkpoint on (re)start (reference:
    tune/trainable/function_trainable.py wrapping vs class Trainable —
    here the class API is bridged onto the session protocol). Stop
    criteria are enforced driver-side in fit(), uniformly for every
    trainable kind; the loop ends when the scheduler/driver stops the
    session (report raises _StopTrial)."""

    def fn(config):
        t = cls(config)
        ckpt = get_checkpoint()
        if ckpt is not None:
            t._restore_full_state(ckpt)
        try:
            while True:
                result = t.train()
                ship = t.iteration % max(1, ckpt_every) == 0
                report(result,
                       checkpoint=t._full_state() if ship else None)
        finally:
            t.stop()

    return fn


def _algo_config_fn(base_config, ckpt_every: int = 1):
    """Drive an rllib AlgorithmConfig as a trial: each trial copies the
    base config, overwrites the sampled hyperparams, builds the
    algorithm (itself a Trainable), and loops train/checkpoint
    (reference: Tuner("PPO", param_space=config) —
    tune/registry + Algorithm-as-Trainable)."""

    def fn(config):
        base = copy.deepcopy(base_config)
        # validated update: a typo'd sweep key raises instead of
        # silently running every trial on defaults
        base.update_from_dict(config)
        algo = base.build()
        ckpt = get_checkpoint()
        if ckpt is not None:
            algo._restore_full_state(ckpt)
        try:
            while True:
                result = algo.train()
                ship = algo.iteration % max(1, ckpt_every) == 0
                report(result,
                       checkpoint=algo._full_state() if ship else None)
        finally:
            algo.stop()

    return fn


# ---------------------------------------------------------------- tuner


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config=None):
        from ray_tpu_torch.train.trainer import RunConfig

        self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored_trials: list[Trial] | None = None
        self._restored_ckpts: dict[str, bytes] = {}

    # -- persistence -----------------------------------------------------

    def _exp_dir(self) -> str:
        name = self.run_config.name or "tune_experiment"
        storage = self.run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        return os.path.join(storage, name)

    def _save_state(self, trials: list[Trial]):
        d = self._exp_dir()
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, ".tuner_state.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"trials": [t.to_json() for t in trials]}, f)
        os.replace(tmp, os.path.join(d, "tuner_state.json"))

    @classmethod
    def restore(cls, path: str, trainable: Callable) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        recorded results; unfinished ones restart FROM THEIR LAST
        CHECKPOINT when one was persisted (reference: Tuner.restore,
        tune/tuner.py + trial checkpoint dirs)."""
        with open(os.path.join(path, "tuner_state.json")) as f:
            state = json.load(f)
        tuner = cls(trainable)
        tuner.run_config.name = os.path.basename(path.rstrip("/"))
        tuner.run_config.storage_path = os.path.dirname(path.rstrip("/"))
        trials = []
        for tj in state["trials"]:
            t = Trial(tj["trial_id"], tj["config"])
            t.status = tj["status"]
            t.last_result = tj["last_result"]
            t.error = tj.get("error")
            if t.status in (Trial.PENDING, Trial.RUNNING):
                t.status = Trial.PENDING  # rerun interrupted trials
                ckpt_file = os.path.join(path, f"ckpt_{t.trial_id}.pkl")
                if os.path.exists(ckpt_file):
                    with open(ckpt_file, "rb") as cf:
                        tuner._restored_ckpts[t.trial_id] = cf.read()
            trials.append(t)
        tuner._restored_trials = trials
        return tuner

    def _persist_checkpoint(self, trial_id: str, blob: bytes):
        d = self._exp_dir()
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".ckpt_{trial_id}.tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(d, f"ckpt_{trial_id}.pkl"))

    # -- trainable resolution --------------------------------------------

    def _resolve_trainable(self) -> tuple[Callable, dict]:
        """Function trainables pass through; Trainable subclasses and
        rllib AlgorithmConfig objects are adapted onto the session
        protocol. AlgorithmConfig fields holding search markers
        (grid_search / Domain) become the param space."""
        from ray_tpu_torch.tune.trainable import is_trainable_class

        t = self._trainable
        param_space = dict(self.param_space or {})
        cc = getattr(self.run_config, "checkpoint_config", None)
        ckpt_every = getattr(cc, "checkpoint_frequency", 1) if cc else 1
        if is_trainable_class(t):
            return _class_trainable_fn(t, ckpt_every), param_space
        if hasattr(t, "build") and hasattr(t, "extract_param_space"):
            algo_space = t.extract_param_space()
            return _algo_config_fn(t, ckpt_every), \
                {**algo_space, **param_space}
        return t, param_space

    # -- fit -------------------------------------------------------------

    def fit(self) -> ResultGrid:
        import ray_tpu_torch as ray

        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        if hasattr(scheduler, "set_objective") and tc.metric:
            scheduler.set_objective(tc.metric, tc.mode)
        searcher = tc.search_alg
        if searcher is not None and hasattr(searcher, "set_objective") \
                and tc.metric:
            searcher.set_objective(tc.metric, tc.mode)
        trainable, param_space = self._resolve_trainable()
        stop_criteria = getattr(self.run_config, "stop", None)
        num_to_create = 0
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif searcher is not None:
            # model-based search: configs are suggested one at a time as
            # slots free, conditioned on completed results
            trials = []
            num_to_create = max(1, tc.num_samples)
        else:
            variants = generate_variants(param_space, tc.num_samples,
                                         tc.seed)
            trials = [Trial(f"trial_{i:05d}", cfg)
                      for i, cfg in enumerate(variants)]
        res = dict(tc.trial_resources or {"CPU": 1.0})
        limit = tc.max_concurrent_trials or max(
            1, int(ray.cluster_resources().get("CPU", 1)))
        actor_cls = ray.remote(**{
            "num_cpus": res.get("CPU", 1.0),
            "resources": {k: v for k, v in res.items() if k != "CPU"},
        })(TrialActor)

        pending = [t for t in trials if t.status == Trial.PENDING]
        running: list[Trial] = []
        ckpts: dict[str, bytes] = {}  # trial_id -> latest checkpoint blob
        self._save_state(trials)
        while pending or running or num_to_create > 0:
            while (pending or num_to_create > 0) and len(running) < limit:
                if pending:
                    t = pending.pop(0)
                else:
                    tid = f"trial_{len(trials):05d}"
                    cfg = searcher.suggest(tid)
                    if cfg is None:
                        num_to_create = 0
                        break
                    num_to_create -= 1
                    t = Trial(tid, cfg)
                    trials.append(t)
                t.actor = actor_cls.options(
                    max_concurrency=2).remote(
                        t.trial_id, trainable, t.config,
                        self._restored_ckpts.get(t.trial_id))
                t.status = Trial.RUNNING
                running.append(t)
                if hasattr(scheduler, "on_trial_add"):
                    scheduler.on_trial_add(t.trial_id, t.config)
            refs = {t.trial_id: t.actor.poll.remote() for t in running}
            for t in list(running):
                try:
                    r = ray.get(refs[t.trial_id], timeout=120)
                except Exception as e:  # noqa: BLE001
                    t.status = Trial.ERROR
                    t.error = f"trial actor failed: {e}"
                    running.remove(t)
                    scheduler.on_trial_complete(t.trial_id)
                    if searcher is not None:
                        searcher.on_trial_complete(t.trial_id, None)
                    continue
                if r.get("checkpoint"):
                    ckpts[t.trial_id] = r["checkpoint"]
                    self._persist_checkpoint(t.trial_id, r["checkpoint"])
                decision = CONTINUE
                hit_stop = False
                for m in r["results"]:
                    t.last_result = m
                    if searcher is not None:
                        searcher.on_trial_result(t.trial_id, m)
                    d = scheduler.on_result(t.trial_id, m)
                    if d == STOP:
                        decision = STOP
                    elif isinstance(d, tuple) and \
                            d[0] in ("EXPLOIT", "REALLOCATE"):
                        decision = d
                    if _stop_met(stop_criteria, m):
                        # pin last_result at the stopping report: an
                        # async trial may have raced a few iterations
                        # past the criteria before we stop it
                        hit_stop = True
                        break
                if r["error"]:
                    t.status = Trial.ERROR
                    t.error = r["error"]
                elif r["done"] or hit_stop:
                    t.status = Trial.TERMINATED
                    if hit_stop and not r["done"]:
                        try:
                            ray.get(t.actor.stop.remote(), timeout=30)
                        except Exception:  # noqa: BLE001
                            pass
                elif isinstance(decision, tuple) and \
                        decision[0] == "REALLOCATE":
                    # resource-changing scheduler: restart this trial
                    # from ITS OWN latest checkpoint with a new resource
                    # request (reference: resource_changing_scheduler.py
                    # — the trial pauses and resumes re-sized)
                    _, new_res = decision
                    own_ckpt = ckpts.get(t.trial_id)
                    if own_ckpt is None:
                        # no checkpoint to resume from yet: tell the
                        # scheduler so its allocation view rolls back
                        # and it retries later
                        if hasattr(scheduler, "on_realloc_aborted"):
                            scheduler.on_realloc_aborted(t.trial_id)
                    else:
                        _retire(ray, t.actor)
                        cls_resized = ray.remote(**{
                            "num_cpus": new_res.get("CPU", 1.0),
                            "resources": {k: v for k, v in new_res.items()
                                          if k != "CPU"},
                        })(TrialActor)
                        t.actor = cls_resized.options(
                            max_concurrency=2).remote(
                                t.trial_id, trainable, t.config, own_ckpt)
                        t.resources = dict(new_res)
                        self._save_state(trials)
                elif isinstance(decision, tuple):
                    # PBT exploit: restart this trial from the source
                    # trial's checkpoint with the mutated config
                    # (reference: pbt.py _exploit)
                    _, source_id, new_config = decision
                    src_ckpt = ckpts.get(source_id)
                    if src_ckpt is None:
                        # no source checkpoint yet: tell the scheduler so
                        # its config view matches the unchanged trial
                        if hasattr(scheduler, "on_exploit_aborted"):
                            scheduler.on_exploit_aborted(t.trial_id)
                    else:
                        _retire(ray, t.actor)
                        t.config = new_config
                        t.actor = actor_cls.options(
                            max_concurrency=2).remote(
                                t.trial_id, trainable, new_config, src_ckpt)
                        if hasattr(scheduler, "on_exploit_applied"):
                            scheduler.on_exploit_applied(t.trial_id)
                        self._save_state(trials)
                elif decision == STOP:
                    t.status = Trial.STOPPED
                    try:
                        ray.get(t.actor.stop.remote(), timeout=30)
                    except Exception:  # noqa: BLE001
                        pass
                if t.status != Trial.RUNNING:
                    # always reap the actor: a terminated trial's worker
                    # process would otherwise keep holding its resources
                    try:
                        ray.kill(t.actor)
                    except Exception:  # noqa: BLE001
                        pass
                    t.actor = None
                    running.remove(t)
                    scheduler.on_trial_complete(t.trial_id)
                    if searcher is not None:
                        searcher.on_trial_complete(t.trial_id, t.last_result)
                    self._save_state(trials)
            time.sleep(0.02)
        self._save_state(trials)
        results = [TuneResult(t.trial_id, t.config, t.last_result, t.error)
                   for t in trials]
        return ResultGrid(results, tc.metric, tc.mode)


def _retire(ray, actor) -> None:
    """End a running trial's actor before its restart elsewhere. Killing
    an actor of the local runtime leaves its trainable's thread running
    (the cluster runtime ends the whole process), so the trial is
    stopped first: its next report unwinds the thread."""
    try:
        ray.get(actor.stop.remote(), timeout=30)
        ray.kill(actor)
    except Exception:  # noqa: BLE001
        pass


def _json_safe(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out

