"""WorkerGroup — the gang of train-worker actors. The port's copy of
``ray_tpu/train/worker_group.py``, on the port's cluster runtime.

Reference parity: ray.train._internal.worker_group.WorkerGroup
(worker_group.py:102) + the actor-side _RayTrainWorker. Workers are
actors placed in one placement group (gang semantics: all-or-nothing,
strategy-shaped — backend_executor.py:142); each runs the user train
function on a dedicated thread with a TrainSession and serves
result-polling calls.

Deviations from the JAX package:

- `TrainWorker.setup_torch` takes the place of ``setup_jax``: it joins
  the gang's ``torch.distributed`` process group at every world size,
  world 1 included (``build_mesh`` needs one), over NCCL when the
  worker claimed a GPU and gloo otherwise, and returns the worker's
  device. Torch has one device a process: a worker is one rank.
- A worker actor claims its bundle's GPU share, so the nodelet hands
  it the card (``CUDA_VISIBLE_DEVICES``); JAX's worker claims nothing.
- The rank's process group is destroyed when its loop ends, so a
  restart starts clean even in a reused process.
- `TrainWorker.next_result` answers as soon as the loop has ended;
  JAX's waits out its whole poll timeout (5 s) on the ended loop's
  empty queue first. The statuses are the same.
- The loop and the dataset shards travel through the port's pickler
  (``core/serialization.py``), not cloudpickle, and the group opens no
  tracing spans (``util/tracing.py`` is not ported).
"""

from __future__ import annotations

import os
import socket
import threading
import time
import traceback
from datetime import timedelta
from typing import Any

from ray_tpu_torch.core import serialization

# how long init_process_group waits for the whole world to join
RENDEZVOUS_TIMEOUT_S = 180.0
# next_result's wait for a report, between looks at the loop's end
_POLL_SLICE_S = 0.05


class TrainWorker:
    """Actor hosted in a worker process. One per train rank."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.session = None

    # -- rendezvous ------------------------------------------------------

    def node_info(self) -> dict:
        """IP + a free port (rank 0's becomes the process group's TCP
        store — reference rendezvous: train/torch/config.py:156 via
        get_address_and_port)."""
        import ray_tpu_torch
        from ray_tpu_torch.core.rpc import node_ip

        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return {"ip": node_ip(), "port": port,
                "node_id": ray_tpu_torch.get_runtime_context().node_id.hex()}

    def setup_env(self, env: dict) -> bool:
        os.environ.update({k: str(v) for k, v in env.items()})
        return True

    def setup_torch(self, init_method: str, world_size: int, rank: int,
                    device: str) -> str:
        """Join the gang's process group (reference seam:
        Backend.on_start — _TorchBackend runs dist.init_process_group
        here, train/torch/config.py:66-124). `device` is what the worker
        claimed: ``"cuda"`` picks NCCL and needs a card in this process,
        ``"cpu"`` picks gloo. Returns the device the loop runs on."""
        import torch
        import torch.distributed as dist

        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"train worker {rank} claimed a GPU but sees no CUDA "
                    f"device (CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
            torch.cuda.set_device(0)
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        return device

    # -- training --------------------------------------------------------

    def start_training(self, fn_blob: bytes, train_loop_config: dict | None,
                       ctx: dict, resume_dir: str | None,
                       dataset_shards_blob: bytes | None = None) -> bool:
        from ray_tpu_torch.train import session as S
        from ray_tpu_torch.train.checkpoint import Checkpoint

        fn = serialization.loads_fn(fn_blob)
        shards = (serialization.loads_fn(dataset_shards_blob)
                  if dataset_shards_blob else None)
        context = S.TrainContext(**ctx)
        resume = Checkpoint(resume_dir) if resume_dir else None
        self.session = S.init_session(context, resume, shards)

        def run():
            try:
                if train_loop_config is not None:
                    result = fn(train_loop_config)
                else:
                    result = fn()
                self.session.final = result
            except BaseException as e:  # noqa: BLE001
                self.session.error = e
                self.session.error_tb = traceback.format_exc()
            finally:
                _destroy_process_group()
                self.session.finished.set()

        threading.Thread(target=run, daemon=True,
                         name=f"train-fn-rank{self.rank}").start()
        return True

    def set_step_waterfall(self, on: bool = True) -> bool:
        """Flip per-step latency attribution in this worker process
        (train/spmd.py waterfall) — works after spmd is imported, unlike
        the RAY_TPU_STEP_WATERFALL env var which is read at import."""
        os.environ["RAY_TPU_STEP_WATERFALL"] = "1" if on else ""
        from ray_tpu_torch.train import spmd

        spmd.enable_step_waterfall(on)
        return True

    def step_waterfall_summary(self) -> dict:
        """This rank's accumulated per-step phase attribution."""
        from ray_tpu_torch.train import spmd

        return spmd.waterfall.summary()

    def next_result(self, timeout: float = 5.0) -> dict:
        """One report from this worker's session, or a status sentinel.
        Driven by the driver's result loop (reference:
        backend_executor.get_next_results :585). Waits up to `timeout`
        for a report, and answers as soon as the loop has ended (JAX's
        waits the whole `timeout` on an ended loop's empty queue)."""
        s = self.session
        if s is None:
            return {"status": "idle"}
        deadline = time.monotonic() + timeout
        while True:
            # read before the drain: once the loop has ended, every
            # report it made is already queued
            ended = s.finished.is_set()
            r = s.next_result(timeout=0 if ended else _POLL_SLICE_S)
            if r is not None:
                return {"status": "report", **r}
            if ended or time.monotonic() >= deadline:
                break
        if ended:
            if s.error is not None:
                return {"status": "error", "error": repr(s.error),
                        "traceback": getattr(s, "error_tb", "")}
            return {"status": "finished", "final": _safe(s.final)}
        return {"status": "running"}

    def ping(self) -> str:
        return "pong"


def _destroy_process_group() -> None:
    """Leave this process's process group, if it is in one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _safe(v):
    try:
        serialization.dumps(v)
        return v
    except Exception:  # noqa: BLE001
        return repr(v)


class WorkerGroupError(RuntimeError):
    def __init__(self, msg, rank=None):
        super().__init__(msg)
        self.rank = rank


class WorkerGroup:
    """N `TrainWorker` actors in one placement group. Each worker claims
    its bundle's GPU share, if any, so the nodelet shows it the card."""

    def __init__(self, num_workers: int,
                 resources_per_worker: dict[str, float] | None = None,
                 placement_strategy: str = "PACK",
                 pg_timeout: float = 60.0):
        import ray_tpu_torch
        from ray_tpu_torch.util.placement_group import (
            placement_group,
            remove_placement_group,
        )

        self.num_workers = num_workers
        res = dict(resources_per_worker or {"CPU": 1.0})
        self._remove_pg = remove_placement_group
        self.pg = placement_group([dict(res) for _ in range(num_workers)],
                                  strategy=placement_strategy)
        if not self.pg.wait(pg_timeout):
            self._remove_pg(self.pg)
            raise WorkerGroupError(
                f"placement group for {num_workers} x {res} not placeable "
                f"within {pg_timeout}s")
        cls = ray_tpu_torch.remote(num_cpus=0,
                                   num_gpus=res.get("GPU", 0) or None)(
            TrainWorker)
        self.workers = [
            cls.options(
                placement_group=self.pg,
                placement_group_bundle_index=i,
                # next_result poll + control calls
                max_concurrency=2,
            ).remote(i, num_workers)
            for i in range(num_workers)
        ]

    def execute(self, method: str, *args, timeout: float | None = 120.0,
                **kwargs) -> list:
        import ray_tpu_torch

        refs = [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_single(self, rank: int, method: str, *args,
                       timeout: float | None = 120.0, **kwargs) -> Any:
        import ray_tpu_torch

        ref = getattr(self.workers[rank], method).remote(*args, **kwargs)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def enable_step_waterfall(self, on: bool = True) -> list:
        """Flip per-step attribution on EVERY rank; fetch the per-rank
        phase tables afterwards with
        ``execute("step_waterfall_summary")`` (straggler ranks show up
        as one rank's compute/collective share diverging)."""
        return self.execute("set_step_waterfall", on)

    def execute_async(self, method: str, *args, **kwargs) -> list:
        return [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]

    def shutdown(self):
        import ray_tpu_torch

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        try:
            self._remove_pg(self.pg)
        except Exception:  # noqa: BLE001
            pass
        self.workers = []
