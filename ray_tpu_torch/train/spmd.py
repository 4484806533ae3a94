"""The train step on one device: the port of ``ray_tpu/train/spmd.py``
at ``zero_stage=0``.

- `TrainState`: params tree, optimizer state, step count and the
  gradient-accumulation buffer.
- `make_train_step(loss_fn, tx)`: ``(state, batch) -> (state, metrics)``.
  The loss's gradient comes from ``torch.autograd.grad``, so on the card
  attention's backward runs the flash kernels K2 and K3. The update is
  written into the state's tensors in place (what ``donate=True`` does
  for the JAX step); metrics are ``loss`` and ``grad_norm``
  (``optax.global_norm``), both left on the device, so a step never
  waits for it.
- `StepWaterfall` (``waterfall``), `enable_step_waterfall` and
  `data_wait`: per-step time attribution, off by default, with the
  phases that exist on one device without XLA: ``data_wait``, ``h2d``,
  ``host`` and ``compute``.

The mesh, partition rules and the ZeRO ladder (``mesh=``, ``rules=``,
``zero_stage >= 1``, ``shard_optimizer=True``) come with the mesh/ZeRO
slice (ROADMAP.md) and raise until then.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.train.optim import GradientTransformation
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.metrics import Histogram

PyTree = Any


class StepWaterfall:
    """Per-step latency attribution for the train path. OFF by default:
    the instrumented step checks one bool, so attribution costs nothing
    when disabled; when enabled it adds a device sync per step (a
    profiling run, not a record run).

    Phases per step: ``data_wait`` (caller-reported input fetch, see
    `note_data_wait`), ``h2d`` (moving host batch leaves to the params'
    device), ``host`` (the loop's own time between steps) and
    ``compute`` (dispatch plus device execution). They sum to the
    loop's wall time."""

    def __init__(self):
        # "0"/"false"/"" all mean OFF
        self.enabled = os.environ.get(
            "RAY_TPU_STEP_WATERFALL", "").strip().lower() \
            not in ("", "0", "false", "no")
        self._lock = threading.Lock()
        self.phases: dict[str, float] = {}  # guarded_by(_lock)
        self.steps = 0  # guarded_by(_lock)
        self._pending_data_wait = 0.0  # guarded_by(_lock)
        self._last_step_end: float | None = None  # guarded_by(_lock)

    def reset(self) -> None:
        with self._lock:
            self.phases = {}
            self.steps = 0
            self._pending_data_wait = 0.0
            self._last_step_end = None

    def step_gap(self, t_start: float, data_wait: float) -> float:
        """Host time between the previous step's end and this step's
        start not already claimed by data_wait (charged to `host`)."""
        with self._lock:
            last = self._last_step_end
        if last is None:
            return 0.0
        return max(0.0, t_start - last - data_wait)

    def mark_step_end(self, t_end: float) -> None:
        with self._lock:
            self._last_step_end = t_end

    def note_data_wait(self, seconds: float) -> None:
        """Report time spent fetching the NEXT batch; charged to the
        next instrumented step."""
        with self._lock:
            self._pending_data_wait += max(0.0, seconds)

    def take_data_wait(self) -> float:
        with self._lock:
            dw, self._pending_data_wait = self._pending_data_wait, 0.0
            return dw

    def add(self, step_phases: dict[str, float]) -> None:
        with self._lock:
            for k, v in step_phases.items():
                if v > 0.0:
                    self.phases[k] = self.phases.get(k, 0.0) + v
            self.steps += 1

    def summary(self) -> dict:
        with self._lock:
            phases = dict(self.phases)
            steps = self.steps
        total = sum(phases.values())
        return {"steps": steps, "total_seconds": total, "phases": phases,
                "percent": {k: (100.0 * v / total if total else 0.0)
                            for k, v in phases.items()}}


waterfall = StepWaterfall()


def enable_step_waterfall(on: bool = True) -> None:
    """Turn per-step attribution on/off in this process (the
    RAY_TPU_STEP_WATERFALL env var sets the initial state)."""
    waterfall.enabled = on


class data_wait:
    """Context manager charging the enclosed block to the next step's
    ``data_wait`` phase — wrap your batch fetch::

        with spmd.data_wait():
            batch = next(batch_iter)
        state, metrics = step(state, batch)

    No-op (beyond two clock reads) when attribution is disabled."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if waterfall.enabled:
            waterfall.note_data_wait(time.perf_counter() - self._t0)
        return False


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: PyTree
    step: int = 0  # microsteps taken; a host int, so no step waits on it
    # gradient-accumulation buffer (None unless accum_steps > 1)
    grad_accum: PyTree = None

    @staticmethod
    def create(params: PyTree, tx: GradientTransformation,
               grad_accum: bool = False) -> "TrainState":
        return TrainState(
            params=params, opt_state=tx.init(params), step=0,
            grad_accum=(tree.tree_map(torch.zeros_like, params)
                        if grad_accum else None))


def _to_device(batch: PyTree, device: torch.device) -> PyTree:
    """Batch leaves (tensors or numpy arrays) on `device`."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device, non_blocking=True)
    return tree.tree_map(move, batch)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    tx: GradientTransformation,
    shard_optimizer: bool = False,
    mesh: Any = None,
    rules: Any = None,
    zero_stage: int | None = None,
    accum_steps: int = 1,
) -> Callable[[TrainState, PyTree], tuple[TrainState, dict]]:
    """Build a train step ``(state, batch) -> (state, metrics)`` on the
    device of the state's params.

    ``accum_steps > 1`` accumulates the microbatch grads in
    ``state.grad_accum`` (make the state with
    ``TrainState.create(..., grad_accum=True)``) and updates on their
    mean every ``accum_steps`` microsteps; ``state.step`` counts
    microsteps and the loss reported each call is the microbatch loss.
    Batch leaves on the host (numpy or CPU tensors) move to the params'
    device inside the step."""
    if mesh is not None or rules is not None or shard_optimizer \
            or (zero_stage or 0) >= 1:
        raise NotImplementedError(
            "mesh=, rules=, zero_stage >= 1 and shard_optimizer=True come "
            "with the mesh/ZeRO slice (ROADMAP.md, queue 1, 'Mesh, "
            "sharding and the ZeRO ladder'); the port's train step runs "
            "on one device")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(state: TrainState, batch: PyTree):
        params = tree.leaves(state.params)
        inputs = [t.detach().requires_grad_() for t in params]
        loss = loss_fn(tree.unflatten(state.params, inputs), batch)
        grads = torch.autograd.grad(loss, inputs)
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            if accum_steps > 1:
                if state.grad_accum is None:
                    raise ValueError(
                        "accum_steps > 1 needs a state made with "
                        "TrainState.create(..., grad_accum=True)")
                acc = tree.leaves(state.grad_accum)
                torch._foreach_add_(acc, grads)
                grads = None
                if (state.step + 1) % accum_steps == 0:
                    grads = torch._foreach_div(acc, float(accum_steps))
                    for a in acc:
                        a.zero_()
            opt_state = state.opt_state
            if grads is not None:
                _, opt_state = tx.update(
                    tree.unflatten(state.params, grads), opt_state,
                    state.params)
        new_state = TrainState(params=state.params, opt_state=opt_state,
                               step=state.step + 1,
                               grad_accum=state.grad_accum)
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    m_step = Histogram(
        "train_step_seconds",
        "Host-side train-step dispatch time (includes device wait when "
        "step attribution is on)",
        boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60))
    m_phase = Histogram(
        "train_step_phase_seconds",
        "Per-step waterfall phases (data_wait/h2d/host/compute) — "
        "populated only while step attribution is enabled",
        boundaries=(0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5,
                    30),
        tag_keys=("phase",))

    def _device(state: TrainState) -> torch.device:
        return tree.leaves(state.params)[0].device

    def _attributed_step(state: TrainState, batch: PyTree):
        """Waterfall-mode step: wall-to-wall phase attribution, with a
        device sync after the h2d copy and after the step."""
        device = _device(state)
        data_wait_s = waterfall.take_data_wait()
        t0 = time.perf_counter()
        gap = waterfall.step_gap(t0, data_wait_s)
        batch = _to_device(batch, device)
        _sync(device)
        t1 = time.perf_counter()
        out = step(state, batch)
        _sync(device)
        t2 = time.perf_counter()
        m_step.observe(t2 - t1)
        phases = {"data_wait": data_wait_s, "h2d": t1 - t0, "host": gap,
                  "compute": t2 - t1}
        for k, v in phases.items():
            if v > 0.0:
                m_phase.observe(v, tags={"phase": k})
        waterfall.add(phases)
        waterfall.mark_step_end(t2)
        return out

    def instrumented(state: TrainState, batch: PyTree):
        if waterfall.enabled:
            return _attributed_step(state, batch)
        t0 = time.perf_counter()
        out = step(state, _to_device(batch, _device(state)))
        m_step.observe(time.perf_counter() - t0)
        return out

    return instrumented
