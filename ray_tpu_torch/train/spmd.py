"""The SPMD train step: the port of ``ray_tpu/train/spmd.py``, on one
device or on a mesh of ``torch.distributed`` ranks.

- `TrainState`: params tree, optimizer state, step count and the
  gradient-accumulation buffer.
- `make_train_step(loss_fn, tx, mesh=, rules=, zero_stage=,
  accum_steps=)`: ``(state, batch) -> (state, metrics)``. The loss's
  gradient comes from ``torch.autograd.grad``, so on the card
  attention's backward runs the flash kernels K2 and K3. The update is
  written into the state's tensors in place (what ``donate=True`` does
  for the JAX step); metrics are ``loss`` and ``grad_norm``
  (``optax.global_norm``), both left on the device, so a step never
  waits for it.
- On a mesh the state's tensors are DTensors (`init_sharded_state`)
  and DTensor inserts the collectives, as GSPMD does for the JAX step:
  the params carry their partition-rule layout (``parallel/sharding.py``),
  the batch is sharded over (data, fsdp) (`batch_shardings`), and the
  ZeRO ladder (`zero_stage` 0-3; `shard_optimizer=True` is stage 1)
  shards one more param-shaped component 1/N over the data axis at
  each rung: the optimizer state (1), the accumulation buffer (2), the
  resident params (3) (`zero_shardings`, `state_shardings`). The step
  keeps the JAX step's order of layouts; see `make_train_step`.
- `optimizer_state_bytes` and the gauges ``train_optimizer_state_bytes``,
  ``train_grad_state_bytes`` and ``train_param_state_bytes``: the bytes
  of each component on the rank that holds the most of it (JAX's max
  over addressable devices).
- `StepWaterfall` (``waterfall``), `enable_step_waterfall` and
  `data_wait`: per-step time attribution, off by default, with the
  phases that exist without XLA: ``data_wait``, ``h2d``, ``host``,
  ``collective.<op>`` (host collectives of ``util/collective.py`` in
  the step) and ``compute``, each laid on the timeline as a
  ``train.step.*`` span; at ZeRO 3 the ``train_zero_gather_share``
  gauge.

Deviation: JAX initialises each shard on its own device and never
holds a whole copy; `init_sharded_state` makes the whole state on every
rank and then lays out rank 0's, so for a moment each rank holds it
all.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.parallel.mesh import AXIS_DATA, BATCH_AXES, mesh_shape
from ray_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionRules,
    PartitionSpec as P,
    add_axis_to_spec,
    path_str,
    placements,
)
from ray_tpu_torch.train.optim import GradientTransformation, global_norm
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.metrics import Gauge, Histogram

PyTree = Any


class StepWaterfall:
    """Per-step latency attribution for the train path. OFF by default:
    the instrumented step checks one bool, so attribution costs nothing
    when disabled; when enabled it adds a device sync per step (a
    profiling run, not a record run).

    Phases per step: ``data_wait`` (caller-reported input fetch, see
    `note_data_wait`), ``h2d`` (moving host batch leaves to the params'
    device), ``host`` (the loop's own time between steps),
    ``collective.<op>`` (host collectives inside the step) and
    ``compute`` (dispatch plus device execution, less those). They sum
    to the loop's wall time."""

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

    def table(self) -> str:
        """Human attribution table: percent of step time per phase."""
        s = self.summary()
        lines = [f"# step attribution over {s['steps']} steps "
                 f"({s['total_seconds']:.3f}s attributed)"]
        for k, v in sorted(s["phases"].items(), key=lambda kv: -kv[1]):
            lines.append(f"#   {k:<24} {v:9.4f}s  {s['percent'][k]:5.1f}%")
        return "\n".join(lines)


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


# ------------------------------------------------------------ layouts


def _state_leaves(obj: Any) -> list:
    out = []
    tree.tree_map_with_path(lambda _, t: out.append(t), obj)
    return out


def batch_shardings(mesh, batch_example: PyTree) -> PyTree:
    """Shard the leading (batch) dim of every leaf over (data, fsdp)."""
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)
    spec = P(axes if axes else None)
    return tree.tree_map(lambda _: NamedSharding(mesh, spec), batch_example)


def _zero_spec(rules: PartitionRules, path, shape, mesh) -> P:
    """A leaf's rule spec, also sharded over the data axis on its first
    evenly-divisible dim (`add_axis_to_spec`)."""
    return add_axis_to_spec(rules.spec_for(path_str(path), mesh),
                            tuple(shape), mesh, AXIS_DATA)


def zero1_shardings(rules: PartitionRules, tree_: PyTree, mesh) -> PyTree:
    """The raw +data-axis layout for a param-shaped tree: each leaf's
    rule spec additionally sharded over the data axis on the first
    evenly-divisible dimension, so N data-parallel replicas each own a
    1/N shard instead of a full copy. Leaves with no divisible dim stay
    on their rule layout. This is the layout every ZeRO rung applies to
    its component — `zero_shardings` decides WHICH components get it per
    stage."""
    return tree.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _zero_spec(rules, path, leaf.shape, mesh)), tree_)


# which ladder rung starts sharding each state component: stage >= rung
# means the component lives resident in the 1/N +data-axis layout
ZERO_LADDER = {"optimizer": 1, "grads": 2, "params": 3}


def zero_shardings(rules: PartitionRules, tree_: PyTree, mesh, stage: int,
                   component: str = "optimizer") -> PyTree:
    """Per-component ZeRO layouts: the `component` ("optimizer" |
    "grads" | "params") tree gets the +data-axis 1/N layout
    (`zero1_shardings`) iff `stage` has reached its ladder rung
    (optimizer: 1, grads: 2, params: 3), else its plain rule layout."""
    if component not in ZERO_LADDER:
        raise ValueError(f"unknown ZeRO component {component!r}; "
                         f"expected one of {sorted(ZERO_LADDER)}")
    if stage >= ZERO_LADDER[component]:
        return zero1_shardings(rules, tree_, mesh)
    return rules.shardings(tree_, mesh)


def _resolve_zero_stage(zero_stage: int | None,
                        shard_optimizer: bool = False) -> int:
    """`zero_stage=None` defers to the legacy `shard_optimizer` bool
    (True == stage 1); an explicit stage wins over the bool."""
    if zero_stage is None:
        return 1 if shard_optimizer else 0
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0|1|2|3, got {zero_stage}")
    return int(zero_stage)


def state_shardings(rules: PartitionRules, state: TrainState, mesh,
                    zero_stage: int = 0) -> TrainState:
    """The layouts of a TrainState at a ladder rung: params, optimizer
    state and accumulation buffer each through `zero_shardings`; the
    step (a host int here) is replicated. Optimizer moments are
    param-shaped subtrees whose paths end with the parameter's own path,
    so the same rules shard them like their parameter."""
    stage = _resolve_zero_stage(zero_stage)
    return TrainState(
        params=zero_shardings(rules, state.params, mesh, stage, "params"),
        opt_state=zero_shardings(rules, state.opt_state, mesh, stage,
                                 "optimizer"),
        step=NamedSharding(mesh, P()),
        grad_accum=(None if state.grad_accum is None else
                    zero_shardings(rules, state.grad_accum, mesh, stage,
                                   "grads")),
    )


def _local_shape(shape, dims, coord, placements_) -> list[int]:
    """The shape of the shard the rank at mesh coordinate `coord`
    holds: each ``Shard(d)`` splits dim d as ``torch.chunk`` does
    (DTensor's layout), mesh dims in order."""
    out = list(shape)
    for n, c, pl in zip(dims, coord, placements_):
        d = getattr(pl, "dim", None)
        if d is None or not pl.is_shard():
            continue
        chunk = -(-out[d] // n)
        out[d] = max(0, min(out[d], (c + 1) * chunk) - c * chunk)
    return out


def optimizer_state_bytes(tree_: PyTree) -> int:
    """Bytes of a state tree on the rank that holds the most of it (the
    JAX package's max over addressable devices): a DTensor counts its
    shard on each rank of its mesh (a replicated leaf whole, a
    ZeRO-sharded leaf 1/N), every plain tensor whole. Named for its
    first (optimizer state) use; the same measure backs the
    ``train_{optimizer,grad,param}_state_bytes`` gauges."""
    plain = 0
    per_rank: dict[int, int] = {}  # global rank -> bytes, over meshes
    for t in _state_leaves(tree_):
        if not isinstance(t, DTensor):
            plain += t.nbytes
            continue
        dims = tuple(t.device_mesh.shape)
        ranks = t.device_mesh.mesh
        for coord in itertools.product(*(range(n) for n in dims)):
            n_el = int(np.prod(_local_shape(t.shape, dims, coord,
                                            t.placements)))
            rank = int(ranks[coord])
            per_rank[rank] = per_rank.get(rank, 0) + \
                n_el * t.element_size()
    return plain + max(per_rank.values(), default=0)


_opt_bytes_gauge = None
_grad_bytes_gauge = None
_param_bytes_gauge = None


def _optimizer_bytes_gauge() -> Gauge:
    global _opt_bytes_gauge
    if _opt_bytes_gauge is None:
        _opt_bytes_gauge = Gauge(
            "train_optimizer_state_bytes",
            "Per-rank optimizer-state bytes (max over the mesh's "
            "ranks), tagged by layout=replicated|zero1 — the ZeRO-1 "
            "memory win made visible pre/post sharding",
            tag_keys=("layout",))
    return _opt_bytes_gauge


def _grad_state_bytes_gauge() -> Gauge:
    global _grad_bytes_gauge
    if _grad_bytes_gauge is None:
        _grad_bytes_gauge = Gauge(
            "train_grad_state_bytes",
            "Per-rank resident gradient-accumulation bytes (max over "
            "the mesh's ranks), tagged by layout=replicated|zero2 — "
            "the ZeRO-2 memory win: grads live reduce-scattered 1/N "
            "between accumulation steps",
            tag_keys=("layout",))
    return _grad_bytes_gauge


def _param_state_bytes_gauge() -> Gauge:
    global _param_bytes_gauge
    if _param_bytes_gauge is None:
        _param_bytes_gauge = Gauge(
            "train_param_state_bytes",
            "Per-rank resident parameter bytes (max over the mesh's "
            "ranks), tagged by layout=replicated|zero3 — the ZeRO-3 "
            "memory win: params live 1/N and are all-gathered "
            "just-in-time inside the step",
            tag_keys=("layout",))
    return _param_bytes_gauge


def _layout(t: DTensor, placements) -> DTensor:
    """`t` redistributed to `placements`, unless it is already there."""
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def _shard_batch(batch: PyTree, mesh) -> PyTree:
    """Host or plain batch leaves, the global batch on every rank, as
    DTensors sharded by `batch_shardings` (each rank keeps its own rows;
    no communication). DTensor leaves stay as they are."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def one(x, sh):
        if isinstance(x, DTensor):
            return x
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return distribute_tensor(x.to(dev, non_blocking=True), mesh,
                                 sh.placements, src_data_rank=None)

    flat = tree.leaves(batch)
    return tree.unflatten(batch, [one(x, sh) for x, sh in zip(
        flat, tree.leaves(batch_shardings(mesh, batch)))])


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    tx: GradientTransformation,
    shard_optimizer: bool = False,
    mesh: Any = None,
    rules: PartitionRules | None = None,
    zero_stage: int | None = None,
    accum_steps: int = 1,
) -> Callable[[TrainState, PyTree], tuple[TrainState, dict]]:
    """Build a train step ``(state, batch) -> (state, metrics)``.

    ``accum_steps > 1`` accumulates the microbatch grads in
    ``state.grad_accum`` (make the state with
    ``TrainState.create(..., grad_accum=True)`` or `init_sharded_state`)
    and updates on their mean every ``accum_steps`` microsteps;
    ``state.step`` counts microsteps and the loss reported each call is
    the microbatch loss.

    Without `mesh` the step runs on the device of the state's params,
    and batch leaves on the host (numpy or CPU tensors) move there
    inside the step. With `mesh` the state's params must be DTensors on
    it (`init_sharded_state`), and the batch, the global batch on every
    rank, is sharded over (data, fsdp). ``zero_stage`` (stage >= 1
    needs `mesh` and `rules`) keeps the JAX step's order of layouts:

    - stage 3: the 1/N-resident params are gathered to their rule
      layout before the loss (a just-in-time all-gather);
    - the grads go first to the rule layout of the params they belong
      to (the pin: a pending sum over the batch axes is reduced there),
      and then, at stage >= 1, to the 1/N layout; the update runs on
      shards;
    - stages 1-2 gather the new params back to the rule layout, written
      into the state's own tensors; stage 3 keeps them 1/N;
    - with ``accum_steps > 1`` the grads accumulate in the buffer's own
      layout (1/N from stage 2).

    Metrics on a mesh are plain tensors, the same on every rank."""
    stage = _resolve_zero_stage(zero_stage, shard_optimizer)
    if stage >= 1 and (mesh is None or rules is None):
        raise ValueError(f"zero_stage={stage} needs mesh= and rules= "
                         "to derive the ZeRO layouts")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    on_mesh = mesh is not None
    layouts: dict[str, list] = {}

    def _plan(state: TrainState) -> None:
        """Each param leaf's rule and ZeRO placements, worked out once
        from the first state's shapes."""
        sharded = [isinstance(t, DTensor) for t in tree.leaves(state.params)]
        if on_mesh and not all(sharded):
            raise ValueError(
                "make_train_step(mesh=) needs a state whose params are "
                "DTensors on the mesh (init_sharded_state)")
        if not on_mesh and any(sharded):
            raise ValueError("a state whose params are DTensors needs "
                             "make_train_step(mesh=)")
        if rules is None:
            # the pin reads each param's own layout
            layouts.update(rule=[], zero=[])
            return
        # in tree.leaves' order, the order the step walks the params in
        paths = [(path, tuple(t.shape))
                 for path, t in tree.leaves_with_path(state.params)]
        layouts.update(
            rule=[placements(rules.spec_for(path_str(path), mesh), mesh)
                  for path, _ in paths],
            zero=[placements(_zero_spec(rules, path, shape, mesh), mesh)
                  for path, shape in paths])

    def step(state: TrainState, batch: PyTree):
        params = tree.leaves(state.params)
        if stage >= 3:
            # just-in-time all-gather of the 1/N-resident params
            params = [_layout(p, pl) for p, pl in
                      zip(params, layouts["rule"])]
        inputs = [t.detach().requires_grad_() for t in params]
        loss = loss_fn(tree.unflatten(state.params, inputs), batch)
        grads = torch.autograd.grad(loss, inputs)
        with torch.no_grad():
            if on_mesh:
                # the pin: each grad in its param's rule layout
                grads = [_layout(g, tuple(p.placements))
                         for g, p in zip(grads, inputs)]
            gnorm = global_norm(grads)
            if accum_steps > 1:
                if state.grad_accum is None:
                    raise ValueError(
                        "accum_steps > 1 needs a state made with "
                        "TrainState.create(..., grad_accum=True)")
                acc = tree.leaves(state.grad_accum)
                if on_mesh:
                    grads = [_layout(g, tuple(a.placements))
                             for g, a in zip(grads, acc)]
                torch._foreach_add_(acc, grads)
                grads = None
                if (state.step + 1) % accum_steps == 0:
                    grads = torch._foreach_div(acc, float(accum_steps))
                    for a in acc:
                        a.zero_()
            opt_state = state.opt_state
            if grads is not None:
                resident = tree.leaves(state.params)
                params_s = resident
                if stage >= 1:
                    grads = [_layout(g, pl) for g, pl in
                             zip(grads, layouts["zero"])]
                if stage in (1, 2):
                    params_s = [_layout(p, pl) for p, pl in
                                zip(resident, layouts["zero"])]
                _, opt_state = tx.update(
                    tree.unflatten(state.params, grads), opt_state,
                    tree.unflatten(state.params, params_s))
                if stage in (1, 2):
                    # gather the updated shards back into the resident
                    # rule-layout tensors
                    for p, new in zip(resident, params_s):
                        p.to_local().copy_(
                            _layout(new, tuple(p.placements)).to_local())
        new_state = TrainState(params=state.params, opt_state=opt_state,
                               step=state.step + 1,
                               grad_accum=state.grad_accum)
        if on_mesh:
            loss = loss.full_tensor()
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    def _place(state: TrainState, batch: PyTree) -> PyTree:
        """The batch where the step reads it: sharded over the mesh, or
        on the params' device."""
        if not layouts:
            _plan(state)
        if on_mesh:
            return _shard_batch(batch, mesh)
        return _to_device(batch, _device(state))

    def _device(state: TrainState) -> torch.device:
        return tree.leaves(state.params)[0].device

    m_step = Histogram(
        "train_step_seconds",
        "Host-side train-step dispatch time (includes device wait when "
        "step attribution is on)",
        boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60))
    m_phase = Histogram(
        "train_step_phase_seconds",
        "Per-step waterfall phases (data_wait/h2d/host/collective/"
        "compute) — populated only while step attribution is enabled",
        boundaries=(0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5,
                    30),
        tag_keys=("phase",))
    m_gather_share = None
    if stage >= 3:
        m_gather_share = Gauge(
            "train_zero_gather_share",
            "Fraction of step time spent in host-observed all_gather "
            "collectives while zero_stage >= 3 — the ZeRO-3 "
            "param-gather tax; input of the train-zero-gather-stall "
            "watchtower rule. Populated while step attribution is on.")

    # resolved once here, so no step pays a first import
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util.collective import _collective_seconds

    def _attributed_step(state: TrainState, batch: PyTree):
        """Waterfall-mode step: wall-to-wall phase attribution, with a
        device sync after the h2d copy and after the step."""
        device = _device(state)
        data_wait_s = waterfall.take_data_wait()
        t0 = time.perf_counter()
        gap = waterfall.step_gap(t0, data_wait_s)
        batch = _place(state, batch)
        _sync(device)
        t1 = time.perf_counter()
        coll0 = _collective_seconds().sums_by_tag("op")
        out = step(state, batch)
        _sync(device)
        t2 = time.perf_counter()
        dt = t2 - t1
        m_step.observe(dt)
        coll_now = _collective_seconds().sums_by_tag("op")
        coll_by_op = {op: v - coll0.get(op, 0.0)
                      for op, v in coll_now.items()
                      if v - coll0.get(op, 0.0) > 0.0}
        coll = sum(coll_by_op.values())
        if coll > dt > 0.0:  # clamp: collectives cannot exceed the step
            scale = dt / coll
            coll_by_op = {op: v * scale for op, v in coll_by_op.items()}
            coll = dt
        phases = {"data_wait": data_wait_s, "h2d": t1 - t0, "host": gap}
        for op, v in coll_by_op.items():
            phases[f"collective.{op}"] = v
        if m_gather_share is not None and dt > 0.0:
            m_gather_share.set(coll_by_op.get("all_gather", 0.0) / dt)
        phases["compute"] = dt - coll
        for k, v in phases.items():
            if v > 0.0:
                m_phase.observe(v, tags={"phase": k})
        # laid-out sub-spans at their true monotonic positions
        # (perf_counter is the monotonic clock on linux;
        # record_interval re-anchors to the epoch)
        if data_wait_s > 0.0:
            tracing.record_interval("train.step.data_wait",
                                    t0 - data_wait_s, t0, category="train")
        if t1 - t0 > 0.0:
            tracing.record_interval("train.step.h2d", t0, t1,
                                    category="train")
        tracing.record_interval("train.step.compute", t1, t2,
                                category="train")
        waterfall.add(phases)
        waterfall.mark_step_end(t2)
        return out

    def instrumented(state: TrainState, batch: PyTree):
        if waterfall.enabled:
            return _attributed_step(state, batch)
        t0 = time.perf_counter()
        out = step(state, _place(state, batch))
        m_step.observe(time.perf_counter() - t0)
        return out

    return instrumented


def init_sharded_state(
    init_fn: Callable[[], PyTree],
    tx: GradientTransformation,
    mesh,
    rules: PartitionRules,
    zero_stage: int = 0,
    accum_steps: int = 1,
) -> TrainState:
    """A TrainState laid out on `mesh` at a ladder rung: ``init_fn()``
    (the whole params on this rank's device) and the optimizer's init,
    then every tensor distributed from rank 0 into its layout
    (`state_shardings`): the optimizer state 1/N from stage 1, the
    accumulation buffer (when ``accum_steps > 1``) from stage 2, the
    params from stage 3. Rank 0's values are the ones every rank gets,
    as in `shard_pytree`. The bytes this rank holds of each component
    go to the ``train_optimizer_state_bytes``,
    ``train_grad_state_bytes`` and ``train_param_state_bytes`` gauges."""
    stage = _resolve_zero_stage(zero_stage)
    full = TrainState.create(init_fn(), tx, grad_accum=accum_steps > 1)

    def place(tree_: PyTree, component: str) -> PyTree:
        zero = stage >= ZERO_LADDER[component]

        def one(path, t):
            spec = (_zero_spec(rules, path, t.shape, mesh) if zero
                    else rules.spec_for(path_str(path), mesh))
            return distribute_tensor(t, mesh, placements(spec, mesh))

        return tree.tree_map_with_path(one, tree_)

    state = TrainState(params=place(full.params, "params"),
                       opt_state=place(full.opt_state, "optimizer"), step=0,
                       grad_accum=(None if full.grad_accum is None
                                   else place(full.grad_accum, "grads")))
    del full
    _optimizer_bytes_gauge().set(
        optimizer_state_bytes(state.opt_state),
        tags={"layout": "zero1" if stage >= 1 else "replicated"})
    _param_state_bytes_gauge().set(
        optimizer_state_bytes(state.params),
        tags={"layout": "zero3" if stage >= 3 else "replicated"})
    if state.grad_accum is not None:
        _grad_state_bytes_gauge().set(
            optimizer_state_bytes(state.grad_accum),
            tags={"layout": "zero2" if stage >= 2 else "replicated"})
    return state
