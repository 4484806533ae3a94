"""Per-worker training session: context, report() and
get_dataset_shard(). The port's copy of ``ray_tpu/train/session.py``
(pure Python).

Reference parity: _TrainSession (train/_internal/session.py:112,
report :405) and the public ray.train.get_context()/report API. The
session lives inside each train-worker actor; `report` hands
(metrics, checkpoint) to the driver's result loop and blocks until the
driver has consumed the previous report, keeping workers in lockstep the
way the reference's continue-lock does."""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: "TrainSession | None" = None
_session_lock = threading.Lock()


@dataclasses.dataclass
class TrainContext:
    """What user code can ask about its place in the world (reference:
    ray.train.get_context() — train/context.py)."""

    world_size: int
    world_rank: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    trial_dir: str
    coordinator_address: str | None

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name


@dataclasses.dataclass
class _Report:
    metrics: dict
    checkpoint_dir: str | None


class TrainSession:
    def __init__(self, context: TrainContext,
                 resume_checkpoint: Checkpoint | None = None,
                 dataset_shards: dict | None = None):
        self.context = context
        self.resume_checkpoint = resume_checkpoint
        self.dataset_shards = dataset_shards or {}
        # maxsize=1: report() blocks until the driver drains the previous
        # round — workers advance in lockstep with the driver loop
        self.results: queue.Queue[_Report] = queue.Queue(maxsize=1)
        self.finished = threading.Event()
        self.error: BaseException | None = None
        self.error_tb: str = ""
        self.final: Any = None

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None):
        self.results.put(
            _Report(dict(metrics), checkpoint.path if checkpoint else None))

    def next_result(self, timeout: float = 0.0) -> dict | None:
        try:
            r = self.results.get(timeout=timeout) if timeout else \
                self.results.get_nowait()
        except queue.Empty:
            return None
        return {"metrics": r.metrics, "checkpoint_dir": r.checkpoint_dir}


def init_session(context: TrainContext,
                 resume_checkpoint: Checkpoint | None = None,
                 dataset_shards: dict | None = None) -> TrainSession:
    global _session
    with _session_lock:
        _session = TrainSession(context, resume_checkpoint, dataset_shards)
        return _session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None


def get_session() -> Optional[TrainSession]:
    return _session


def get_context() -> TrainContext:
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() outside a "
                           "train worker session")
    return s.context


def report(metrics: dict, checkpoint: Checkpoint | None = None):
    """Report metrics (and optionally a checkpoint) to the driver
    (reference: ray.train.report, session.py:405)."""
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() outside a train "
                           "worker")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Checkpoint | None:
    """The checkpoint to resume from, if the run was restored."""
    s = get_session()
    return s.resume_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a Dataset passed to the trainer's
    ``datasets=`` (reference: ray.train.get_dataset_shard — the
    prepare_data_loader role: per-worker streaming ingestion)."""
    s = get_session()
    if s is None:
        raise RuntimeError("get_dataset_shard() outside a train worker")
    shard = s.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset {name!r} was passed to the trainer "
            f"(have: {sorted(s.dataset_shards)})")
    return shard
