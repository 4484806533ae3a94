"""1F1B pipeline-parallel train strategy over a WorkerGroup — flat and
interleaved schedules, composed with intra-stage ZeRO sharding. The
port of ``ray_tpu/train/pipeline_strategy.py``, on the port's cluster
runtime.

Each pipeline STAGE is its own worker actor holding only its stage's
parameters, and activations/grad-activations stream stage-to-stage
through the object store (the driver only wires ObjectRefs: each
stage's output is a host array that the next stage's call takes as an
argument).

Scheduling is deliberately SUBMISSION-ORDER-IS-EXECUTION-ORDER: stage
workers run FIFO (max_concurrency=1), the driver submits each stage's
calls in its exact schedule order, and every call's input is an
ObjectRef produced by an earlier submission (the submission orders are
topological) — so the gang executes the textbook interleave and the
whole schedule is testable as data. Two schedules:

- flat 1F1B (`one_f_one_b_submission_order`): bubble (S-1)/(S-1+M);
- interleaved (`num_repeats=R > 1`,
  `interleaved_1f1b_submission_order`): each worker owns R VIRTUAL
  stages placed round-robin (virtual stage v on worker v % S), each op
  costs ~1/R of a flat-stage op, and the fill/drain bubble drops to
  (S-1)/(R*M + S-1) at the SAME stage and microbatch counts.

The stage's programs keep the JAX strategy's memory shape: `forward`
runs the chunk under ``torch.no_grad()`` and parks only its input;
`backward` runs the chunk again with grad enabled from the parked input
and takes ``torch.autograd.grad`` with the incoming cotangent (the last
virtual stage seeds with 1/M, so the accumulated grads are those of the
mean loss). `finish_step` applies SGD(+momentum) per chunk.

ZeRO composes per stage (`zero_stage`, `data_parallel=D`): the D
members of a stage are D worker processes (a torch process drives one
device) joined by a process group of their own; no collective crosses
stages. The stage's layouts are the train/spmd.py ladder
(`zero1_shardings`) on a ``data`` mesh of that group: grads are pinned
to the replicated layout then scattered 1/D (stage >= 2 keeps the
accumulated grads resident scattered between microbatches), momentum
state lives 1/D (stage >= 1), and resident params live 1/D with a
just-in-time gather before each op (stage 3). `stage_apply(mesh=...)`
splits the microbatch over the group. At D = 1 a stage uses plain
tensors: no process group and no DTensor.

The bubble is measured, not assumed: each stage reports per-op busy
time and its step window; `train_step` computes
``bubble_ratio = 1 - busy / (S * makespan)`` and surfaces it on the
`train_pipeline_bubble_ratio` gauge, alongside
`train_pipeline_virtual_stages` (S*R). An op's span is its compute
alone: it opens once the op's inputs are on the device and closes
before its output is copied to the host, so each hop's copies count as
idle time, as the put and the get do. An op's busy time is never more
than its span, so ``0 <= bubble_ratio < 1`` holds by construction: on
the card it is the span, the device synchronised at both ends; on the
CPU it is the process's CPU time in the op, bounded by the span (CPU
time alone sums every intra-op thread and can exceed it). The
theoretical floors come from
`parallel.pipeline.theoretical_bubble` and
`theoretical_bubble_interleaved`.

Deviations from the JAX package:

- `PipelineStrategy(device=...)`: ``"cuda"`` (the default) or
  ``"cpu"``, in place of the JAX strategy's ``JAX_PLATFORMS`` probe. A
  ``cuda`` stage claims a GPU share in its bundle (default
  ``{"CPU": 1, "GPU": 1}``) and raises if it sees no card; a claim
  without a GPU share raises ``ValueError``.
- A stage of D > 1 is D processes in a process group of their own
  (``setup_stage``), where JAX runs one process over D local devices.
  The driver submits each op to every member in the same order; member
  0's outputs travel on, the others return None.
- The busy clock and the span, as above (JAX counts
  ``time.process_time()`` alone, over a span that holds the op's
  host-to-device copy).
- Params travel as numpy trees through the port's serialization, and
  checkpoint shards are standard pickles of lists of numpy trees (JAX
  writes them with cloudpickle; `load_pipeline_checkpoint` reads both).
  `full_params` and `load_pipeline_checkpoint` return CPU tensors.
- Each op's compute span is also recorded on the stage's timeline
  (``pipeline.stage<s>.v<v>.<kind>.mb<m>``), and a step is a
  ``pipeline.train_step`` span, as in JAX. `finish_step` also
  adds each op's span to its stats (``op_spans``: the compute alone,
  with the seconds of the op's host-to-device copy before it and its
  device-to-host copy after it beside), and the stage process's pid,
  device, intra-op threads, peak device memory and hand-written kernel
  launches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
import time
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ray_tpu_torch.core import serialization
from ray_tpu_torch.parallel.pipeline import (
    interleaved_1f1b_submission_order,
    one_f_one_b_submission_order,
    theoretical_bubble,
    theoretical_bubble_interleaved,
)
from ray_tpu_torch.train.worker_group import (
    RENDEZVOUS_TIMEOUT_S,
    WorkerGroup,
    free_port,
)
from ray_tpu_torch.util import tree

# every get of a step's results
STEP_TIMEOUT_S = 300.0

_bubble_gauge = None
_micro_counter = None
_virtual_gauge = None


def _strategy_metrics():
    global _bubble_gauge, _micro_counter, _virtual_gauge
    if _bubble_gauge is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _bubble_gauge = Gauge(
            "train_pipeline_bubble_ratio",
            "Measured 1F1B pipeline bubble fraction of the last step: "
            "1 - stage-busy / (stages * makespan); compare against "
            "(S-1)/(S-1+M) flat or (S-1)/(R*M+S-1) interleaved")
        _micro_counter = Counter(
            "train_microbatches_total",
            "Microbatches executed by the pipeline train strategy")
        _virtual_gauge = Gauge(
            "train_pipeline_virtual_stages",
            "Virtual pipeline stages (stages * repeats) of the running "
            "pipeline strategy — >num_stages means the interleaved "
            "schedule is active")
    return _bubble_gauge, _micro_counter, _virtual_gauge


def _tmap(fn, *trees):
    """`fn` over the leaves of trees of one structure (lists included)."""
    flat = [tree.leaves(t) for t in trees]
    return tree.unflatten(trees[0], [fn(*xs) for xs in zip(*flat)])


def _whole(t):
    """The global value of a (possibly DTensor) tensor as a plain tensor:
    the stage-3 just-in-time gather (a collective on a DTensor)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _numpy_tree(tree_):
    """A param tree (tensors, DTensors gathered, or array-likes) as numpy
    arrays on the host."""
    return _tmap(lambda t: _whole(t).detach().cpu().numpy()
                 if isinstance(t, torch.Tensor) else np.asarray(t), tree_)


def _torch_tree(tree_):
    """Numpy trees -> CPU tensors (copies: store views are read-only)."""
    return _tmap(lambda a: torch.from_numpy(np.array(a)), tree_)


class PipelineStageWorker:
    """Actor owning ONE pipeline stage (or one member of a stage's
    data-parallel group): its parameter chunks (R virtual stages when
    interleaved), the 1F1B forward/backward for each microbatch (only
    the input kept per in-flight (repeat, microbatch); the backward
    rematerialises the chunk), grad accumulation in the ZeRO layout,
    and the end-of-step SGD(+momentum) update. Methods execute FIFO —
    the driver's submission order is the schedule."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.stage = rank
        self.num_stages = world_size
        self.member = 0
        self.num_repeats = 1
        self.zero_stage = 0
        self.data_parallel = 1
        self.momentum = 0.0
        self.cfg = None
        self.device = None          # torch.device, set by setup_stage
        self.params = None          # list over repeats of chunk trees
        self.mesh = None            # ("data",) mesh when D > 1
        self.lr = 0.0
        self.num_microbatches = 1
        self._saved: dict[tuple[int, int], Any] = {}  # (r, mb) -> inputs
        self._grads: list[Any] = []      # per repeat, ZeRO layout
        self._vel: list[Any] | None = None
        self._ops: list[tuple] = []  # (kind, v, mb, t0, t1, h2d_s, d2h_s)
        self._busy = 0.0            # work seconds inside ops (see _done)
        self.emulate: tuple[float, float] | None = None
        self._last_state_bytes: dict[str, int] = {}

    # ------------------------------------------------------------------

    def rendezvous_address(self) -> str:
        """``tcp://ip:port`` with a free port of this host: member 0's
        becomes its stage group's TCP store."""
        from ray_tpu_torch.core.rpc import node_ip

        return f"tcp://{node_ip()}:{free_port()}"

    def setup_stage(self, device: str, data_parallel: int = 1,
                    init_method: str | None = None) -> str:
        """Place this worker: stage rank // D, member rank % D of S = world
        // D stages, on `device` (``"cuda"``: the card the nodelet shows
        this process, which must see one). With D > 1 the stage's
        members join a process group of their own (NCCL on the card,
        gloo on the CPU) at `init_method`; every member calls this at
        once. Returns the device."""
        D = int(data_parallel)
        self.data_parallel = D
        self.stage, self.member = divmod(self.rank, D)
        self.num_stages = self.world_size // D
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"pipeline stage {self.stage} claimed a GPU but sees "
                    f"no CUDA device (CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
            torch.cuda.set_device(0)
            self.device = torch.device("cuda", 0)
        elif device == "cpu":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        if D > 1:
            dist.init_process_group(
                "nccl" if device == "cuda" else "gloo",
                init_method=init_method, world_size=D, rank=self.member,
                timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        return device

    def leave_group(self) -> bool:
        """Leave the stage's process group (the process may be reused)."""
        self.mesh = None
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        return True

    def load_stage(self, cfg_kwargs: dict, params_blob: bytes, lr: float,
                   num_microbatches: int, num_repeats: int = 1,
                   zero_stage: int = 0, data_parallel: int = 1,
                   momentum: float = 0.0,
                   emulate_ms: tuple | None = None) -> int:
        """Install this worker's config + its R virtual-stage param
        chunks (params_blob: a serialized list of numpy trees, chunk r
        == virtual stage r*S + stage). Returns the worker's parameter
        count (the driver logs the split).

        `emulate_ms=(fwd_ms, bwd_ms)` switches the worker into schedule
        emulation: ops sleep a modeled per-chunk duration (the full
        stage's cost split across R virtual-stage chunks) instead of
        computing, while everything else — submission order, FIFO
        execution, activation hand-off through the object store, span
        and busy accounting — stays the real path."""
        from ray_tpu_torch.models.pipelined import PipelinedConfig

        if self.device is None:
            raise RuntimeError("load_stage before setup_stage")
        if int(data_parallel) != self.data_parallel:
            raise ValueError(
                f"stage {self.stage}: data_parallel={data_parallel} but "
                f"the stage was set up with {self.data_parallel}")
        self.cfg = PipelinedConfig(**cfg_kwargs)
        self.lr = float(lr)
        self.num_microbatches = int(num_microbatches)
        self.num_repeats = int(num_repeats)
        self.zero_stage = int(zero_stage)
        self.momentum = float(momentum)
        self.emulate = (tuple(float(x) / 1e3 for x in emulate_ms)
                        if emulate_ms else None)
        chunks = serialization.loads(params_blob)
        if not isinstance(chunks, list):  # single-chunk (flat) callers
            chunks = [chunks]
        if self.data_parallel > 1:
            from ray_tpu_torch.parallel.mesh import build_mesh

            self.mesh = build_mesh({"data": self.data_parallel},
                                   device=self.device.type)
        chunks = [_tmap(lambda t: t.to(self.device), _torch_tree(c))
                  for c in chunks]
        # params enter resident in their ZeRO layout: 1/D when stage 3,
        # replicated otherwise
        self.params = [self._to_layout(c, self.zero_stage >= 3)
                       for c in chunks]
        self._grads = [None] * self.num_repeats
        self._vel = None
        if self.momentum:
            self._vel = [self._to_layout(_tmap(torch.zeros_like, c),
                                         self.zero_stage >= 1)
                         for c in chunks]
        return sum(x.numel() for c in chunks for x in tree.leaves(c))

    # -- layouts ---------------------------------------------------------

    def _to_layout(self, tree_, sharded: bool):
        """A chunk tree of plain tensors (the global value, the same on
        every member) in its resident layout: DTensors in the +data-axis
        1/D ZeRO layout when `sharded` (and a data mesh exists), else
        plain tensors (a replicated leaf holds the whole value either
        way). No communication: each member keeps its own slice."""
        if self.mesh is None or not sharded:
            return tree_
        from ray_tpu_torch.parallel.sharding import PartitionRules
        from ray_tpu_torch.train.spmd import zero1_shardings

        # catch-all replicated rules: the stage's base layout is
        # replicated over its data group, so the ZeRO layout is purely
        # the +data axis on the first evenly-divisible dim
        layouts = zero1_shardings(PartitionRules([]), tree_, self.mesh)

        def one(t, sh):
            d = DTensor.from_local(t, self.mesh, [Replicate()],
                                   run_check=False)
            return d.redistribute(self.mesh, sh.placements)

        return _tmap(one, tree_, layouts)

    @staticmethod
    def _like(t, like):
        """`t` in `like`'s layout (a gather when `t` is 1/D and `like`
        whole; a local slice the other way)."""
        t_d, like_d = isinstance(t, DTensor), isinstance(like, DTensor)
        if not t_d and not like_d:
            return t
        if t_d and not like_d:
            return t.full_tensor()
        if not t_d:
            t = DTensor.from_local(t, like.device_mesh, [Replicate()],
                                   run_check=False)
        if tuple(t.placements) == tuple(like.placements):
            return t
        return t.redistribute(like.device_mesh, like.placements)

    # -- ops -------------------------------------------------------------

    def _put_batch(self, arr):
        """A host activation/batch leaf on this stage's device (the
        whole microbatch: `stage_apply` splits it over a data mesh)."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return torch.from_numpy(np.array(arr)).to(self.device)

    def _to_host(self, t):
        """An output for the next stage: a host array from member 0,
        None from the others (a DTensor output is gathered on all)."""
        t = _whole(t)
        if self.member != 0:
            return None
        return t.detach().cpu().numpy()

    def _start(self) -> tuple[float, float]:
        """Open an op's compute span once its inputs are on the device:
        (wall, process CPU) clocks."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter(), time.process_time()

    def _done(self, t0: float, c0: float) -> float:
        """Close an op's compute span and return its end. Busy is never
        more than the span: on the card the span itself, the device
        synchronised first; on the CPU the process's CPU time in the op
        (which sums every intra-op thread), bounded by the span. The
        op's copies to and from the host lie outside the span: they are
        part of the hop, and `op_spans` carries their seconds."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        wall = t1 - t0
        if self.device.type == "cuda":
            self._busy += wall
        else:
            self._busy += min(time.process_time() - c0, wall)
        return t1

    def _emulated(self, kind: str, v: int, mb: int, t0: float) -> None:
        dur = self.emulate[0 if kind == "fwd" else 1] / self.num_repeats
        time.sleep(dur)
        self._busy += dur
        t1 = time.perf_counter()
        self._ops.append((kind, v, mb, t0, t1, 0.0, 0.0))
        self._trace(kind, t0, t1, v, mb)

    def _trace(self, kind: str, t0: float, t1: float, v: int,
               mb: int) -> None:
        from ray_tpu_torch.util import tracing

        tracing.record_interval(
            f"pipeline.stage{self.stage}.v{v}.{kind}.mb{mb}", t0, t1,
            category="train")

    def _run_chunk(self, r: int, params, x, targets):
        from ray_tpu_torch.models.pipelined import stage_apply

        V = self.num_stages * self.num_repeats
        v = r * self.num_stages + self.stage
        return stage_apply(self.cfg, params, v, V, x, targets=targets,
                           mesh=self.mesh)

    def _compute_params(self, r: int):
        # stage 3: resident 1/D, gathered just in time
        return _tmap(_whole, self.params[r])

    def forward(self, r: int, mb: int, payload, targets=None):
        """Forward one microbatch through virtual stage r*S + stage:
        payload is tokens (virtual stage 0) or the previous virtual
        stage's activation. Returns the activation for the next virtual
        stage, or the microbatch loss on the last. The inputs park until
        `backward(r, mb)`."""
        h0 = time.perf_counter()
        v = r * self.num_stages + self.stage
        last = v == self.num_stages * self.num_repeats - 1
        if self.emulate is not None:
            self._saved[(r, mb)] = (payload,)
            self._emulated("fwd", v, mb, h0)
            return 0.0 if last else payload
        x = self._put_batch(payload)
        tgt = self._put_batch(targets) if last else None
        t0, c0 = self._start()
        with torch.no_grad():
            out = self._run_chunk(r, self._compute_params(r), x, tgt)
        self._saved[(r, mb)] = (x, tgt) if last else (x,)
        t1 = self._done(t0, c0)
        # the driver reads the microbatch loss straight off this call's
        # ObjectRef — no separate loss plumbing
        res = float(_whole(out)) if last else self._to_host(out)
        self._ops.append(("fwd", v, mb, t0, t1, t0 - h0,
                          time.perf_counter() - t1))
        self._trace("fwd", t0, t1, v, mb)
        return res

    def backward(self, r: int, mb: int, grad=None):
        """Backward one microbatch through virtual stage r*S + stage:
        grad is the next virtual stage's activation cotangent (None on
        the last, which seeds with 1/M so the accumulated grads are
        those of the MEAN loss). Returns the cotangent for the previous
        virtual stage (True from virtual stage 0)."""
        h0 = time.perf_counter()
        v = r * self.num_stages + self.stage
        saved = self._saved.pop((r, mb))
        if self.emulate is not None:
            self._emulated("bwd", v, mb, h0)
            return True if v == 0 else saved[0]
        first = v == 0
        seed = None if grad is None else self._put_batch(grad)
        t0, c0 = self._start()
        tgt = saved[1] if len(saved) > 1 else None
        live = _tmap(lambda p: p.detach().requires_grad_(True),
                     self._compute_params(r))
        x = saved[0]
        if not first:
            # chunk 0's input is int tokens: no cotangent for it
            x = x.detach().requires_grad_(True)
        leaves = tree.leaves(live)
        with torch.enable_grad():
            out = self._run_chunk(r, live, x, tgt)
            if grad is None:
                out = out * (1.0 / self.num_microbatches)
            elif isinstance(out, DTensor):
                seed = distribute_tensor(seed, out.device_mesh,
                                         out.placements, src_data_rank=None)
            got = torch.autograd.grad(
                out, leaves + ([] if first else [x]), grad_outputs=seed)
        dparams = [_whole(g) for g in got[:len(leaves)]]
        dparams = self._to_layout(tree.unflatten(live, dparams),
                                  self.zero_stage >= 2)
        if self._grads[r] is None:
            self._grads[r] = dparams
        else:
            # accumulate in the resident layout — scattered 1/D when
            # zero_stage >= 2: this buffer IS the ZeRO-2 grad state
            self._grads[r] = _tmap(torch.add, self._grads[r], dparams)
        t1 = self._done(t0, c0)
        res = True if first else self._to_host(got[-1])
        self._ops.append(("bwd", v, mb, t0, t1, t0 - h0,
                          time.perf_counter() - t1))
        self._trace("bwd", t0, t1, v, mb)
        return res

    def finish_step(self) -> dict:
        """Apply the accumulated grads per chunk (SGD(+momentum),
        matching `pipelined_train_step` at momentum=0) and report this
        stage's timing — busy seconds and the step window (the driver's
        bubble inputs), each op's span and the seconds of its host
        copies — plus the per-device resident bytes of each state
        component, measured at the point the grad state is fully
        accumulated (the honest ZeRO-2 number), and the process's
        facts (`_process_facts`)."""
        from ray_tpu_torch.train.spmd import optimizer_state_bytes

        if self._saved:
            raise RuntimeError(
                f"stage {self.stage}: {len(self._saved)} microbatches "
                f"never ran backward — schedule bug")

        def nbytes(t):
            return 0 if t is None else optimizer_state_bytes(t)

        self._last_state_bytes = {
            "param_state_bytes": nbytes(self.params),
            "grad_state_bytes": nbytes(
                [g for g in self._grads if g is not None]),
            "velocity_state_bytes": nbytes(self._vel),
        }
        for r in range(self.num_repeats):
            if self._grads[r] is None:
                continue
            g = self._grads[r]
            if self._vel is not None:
                self._vel[r] = _tmap(
                    lambda vv, gg: self.momentum * vv + self._like(gg, vv),
                    self._vel[r], g)
                g = self._vel[r]
            self.params[r] = _tmap(
                lambda pp, gg: pp - self.lr * self._like(gg, pp),
                self.params[r], g)
            self._grads[r] = None
        ops, self._ops = self._ops, []
        busy, self._busy = self._busy, 0.0
        busy_wall = sum(o[4] - o[3] for o in ops)
        window = (max(o[4] for o in ops) - min(o[3] for o in ops)
                  if ops else 0.0)
        return {"stage": self.stage, "member": self.member,
                "busy_s": busy, "busy_wall_s": busy_wall,
                "window_s": window, "ops": len(ops), "op_spans": ops,
                "copy_s": sum(o[5] + o[6] for o in ops),
                **self._last_state_bytes, **self._process_facts()}

    def get_params(self) -> bytes:
        """This worker's current chunk params (a standard pickle of a
        list over repeats of numpy trees) — checkpoint shards and the
        parity tests' merge path. A member other than 0 of a stage
        group joins the gather and returns b""."""
        chunks = [_numpy_tree(c) for c in self.params]
        return pickle.dumps(chunks) if self.member == 0 else b""

    def _process_facts(self) -> dict:
        """This stage process: its pid, device, torch's intra-op
        threads, peak device memory and the launches of the port's
        hand-written kernels so far (0 for a kernel whose module this
        process never imported)."""
        out = {"pid": os.getpid(), "device": str(self.device),
               "intra_op_threads": torch.get_num_threads(),
               "device_name": None, "peak_bytes": None, "launches": {}}
        if self.device is not None and self.device.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(self.device)
            out["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        fa = sys.modules.get("ray_tpu_torch.ops.flash_attention")
        pa = sys.modules.get("ray_tpu_torch.ops.paged_attention")
        for name, mod, attr in (("flash_fwd", fa, "LAUNCHES"),
                                ("flash_dq", fa, "LAUNCHES_DQ"),
                                ("flash_dkv", fa, "LAUNCHES_DKV"),
                                ("paged_attention", pa, "LAUNCHES")):
            out["launches"][name] = getattr(mod, attr).count if mod else 0
        return out

    def ping(self) -> str:
        return "pong"


@dataclasses.dataclass
class PipelineStepMetrics:
    loss: float
    bubble_ratio: float
    bubble_theoretical: float
    step_seconds: float
    microbatches: int
    virtual_stages: int = 0
    num_repeats: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PipelineStrategy:
    """Drive 1F1B pipeline-parallel training of the pipelined
    transformer over `num_stages` stage workers — optionally interleaved
    (`num_repeats=R` virtual stages per worker) and/or composed with
    intra-stage ZeRO data parallelism (`zero_stage`, `data_parallel`).

    ::

        ps = PipelineStrategy(PipelinedConfig(), num_stages=2,
                              num_microbatches=8, num_repeats=2,
                              zero_stage=3, data_parallel=2)
        for _ in range(steps):
            metrics = ps.train_step({"tokens": ..., "targets": ...})
        ps.shutdown()

    Stages run on ``device="cuda"`` unless the caller asks for
    ``"cpu"``."""

    def __init__(self, cfg, num_stages: int,
                 num_microbatches: int | None = None, lr: float = 1e-2,
                 seed: int = 0, params=None,
                 resources_per_worker: dict | None = None,
                 placement_strategy: str = "PACK",
                 num_repeats: int = 1, zero_stage: int = 0,
                 data_parallel: int = 1, momentum: float = 0.0,
                 emulate_ms: tuple | None = None, device: str = "cuda"):
        import ray_tpu_torch
        from ray_tpu_torch.models.pipelined import (
            PipelinedConfig,
            split_pipeline_stages_interleaved,
        )

        self.cfg = (cfg if isinstance(cfg, PipelinedConfig)
                    else PipelinedConfig(**dict(cfg or {})))
        self.num_stages = num_stages
        self.num_repeats = int(num_repeats)
        self.zero_stage = int(zero_stage)
        self.data_parallel = int(data_parallel)
        self.momentum = float(momentum)
        self.emulate_ms = tuple(emulate_ms) if emulate_ms else None
        self.num_microbatches = int(
            num_microbatches or self.cfg.num_microbatches)
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0|1|2|3, "
                             f"got {zero_stage}")
        if self.data_parallel < 1:
            raise ValueError(f"data_parallel must be >= 1, got "
                             f"{data_parallel}")
        if self.num_repeats > 1 and self.num_microbatches < num_stages:
            raise ValueError(
                f"interleaved schedule needs microbatches "
                f"{self.num_microbatches} >= stages {num_stages}")
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        res = dict(resources_per_worker or (
            {"CPU": 1.0, "GPU": 1.0} if device == "cuda" else {"CPU": 1.0}))
        if device == "cuda" and not res.get("GPU", 0) > 0:
            raise ValueError(
                f"device='cuda' but resources_per_worker={res} claims no "
                f"GPU; add a GPU share or pass device='cpu'")
        self.lr = lr
        if params is None:
            from ray_tpu_torch.models.pipelined import init_pipelined

            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            params = init_pipelined(gen, self.cfg, device=device)
        stages = split_pipeline_stages_interleaved(
            _numpy_tree(params), self.cfg, num_stages, self.num_repeats)
        D = self.data_parallel
        # FIFO workers: the schedule submission order must BE the
        # per-stage execution order (see module docstring)
        self.wg = WorkerGroup(
            num_workers=num_stages * D,
            resources_per_worker=res,
            placement_strategy=placement_strategy,
            worker_cls=PipelineStageWorker,
            max_concurrency=1,
        )
        # members[s][d]: member d of stage s
        self.members = [self.wg.workers[s * D:(s + 1) * D]
                        for s in range(num_stages)]
        try:
            addrs = [self.wg.execute_single(s * D, "rendezvous_address")
                     if D > 1 else None for s in range(num_stages)]
            ray_tpu_torch.get(
                [w.setup_stage.remote(device, D, addrs[i // D])
                 for i, w in enumerate(self.wg.workers)],
                timeout=RENDEZVOUS_TIMEOUT_S)
            cfg_kwargs = dataclasses.asdict(self.cfg)
            blobs = [serialization.dumps(stages[s])
                     for s in range(num_stages)]
            counts = ray_tpu_torch.get(
                [w.load_stage.remote(
                    cfg_kwargs, blobs[i // D], lr, self.num_microbatches,
                    self.num_repeats, self.zero_stage, D, self.momentum,
                    self.emulate_ms)
                 for i, w in enumerate(self.wg.workers)],
                timeout=RENDEZVOUS_TIMEOUT_S)
            self.stage_param_counts = counts[::D]
        except Exception:
            self.shutdown()
            raise
        self.last_metrics: PipelineStepMetrics | None = None
        self.last_stage_stats: list[dict] | None = None

    # ------------------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One pipelined step over the whole batch: split into M
        microbatches, stream activations down / cotangents up the
        virtual-stage chain (flat or interleaved order), then apply
        each stage's update. Returns {loss, bubble_ratio,
        bubble_theoretical, step_seconds, microbatches, virtual_stages,
        num_repeats}."""
        import ray_tpu_torch
        from ray_tpu_torch.util import tracing

        S, M, R = self.num_stages, self.num_microbatches, self.num_repeats
        V = S * R
        tokens = np.asarray(batch["tokens"])
        targets = np.asarray(batch["targets"])
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by "
                             f"microbatches {M}")
        mb = B // M
        order = (interleaved_1f1b_submission_order(S, M, R) if R > 1
                 else one_f_one_b_submission_order(S, M))
        t0 = time.perf_counter()
        with tracing.span("pipeline.train_step", category="train"):
            fwd: dict[tuple[int, int], Any] = {}
            bwd: dict[tuple[int, int], Any] = {}
            others: list = []  # members > 0: they return None
            for kind, v, m in order:
                lead, *rest = self.members[v % S]
                r = v // S
                if kind == "fwd":
                    payload = (tokens[m * mb:(m + 1) * mb] if v == 0
                               else fwd[(v - 1, m)])
                    tgt = (targets[m * mb:(m + 1) * mb]
                           if v == V - 1 else None)
                    fwd[(v, m)] = lead.forward.remote(r, m, payload, tgt)
                    others += [w.forward.remote(r, m, payload, tgt)
                               for w in rest]
                else:
                    g = bwd[(v + 1, m)] if v < V - 1 else None
                    bwd[(v, m)] = lead.backward.remote(r, m, g)
                    others += [w.backward.remote(r, m, g) for w in rest]
            losses = ray_tpu_torch.get([fwd[(V - 1, m)] for m in range(M)],
                                       timeout=STEP_TIMEOUT_S)
            ray_tpu_torch.get([bwd[(0, m)] for m in range(M)] + others,
                              timeout=STEP_TIMEOUT_S)
            stats = self.wg.execute("finish_step", timeout=STEP_TIMEOUT_S)
        dt = time.perf_counter() - t0
        stats = stats[::self.data_parallel]  # member 0 of each stage
        makespan = max(st["window_s"] for st in stats)
        busy = sum(st["busy_s"] for st in stats)
        bubble = (1.0 - busy / (S * makespan)) if makespan > 0 else 0.0
        m_bubble, m_micro, m_virtual = _strategy_metrics()
        m_bubble.set(bubble)
        m_micro.inc(M)
        m_virtual.set(float(V))
        self.last_stage_stats = stats
        self.last_metrics = PipelineStepMetrics(
            loss=float(np.mean(losses)),
            bubble_ratio=bubble,
            bubble_theoretical=(
                theoretical_bubble_interleaved(S, M, R) if R > 1
                else theoretical_bubble(S, M)),
            step_seconds=dt,
            microbatches=M,
            virtual_stages=V,
            num_repeats=R,
        )
        return self.last_metrics.as_dict()

    def _stage_shards(self) -> list[bytes]:
        blobs = self.wg.execute("get_params", timeout=STEP_TIMEOUT_S)
        return blobs[::self.data_parallel]

    def full_params(self):
        """Merge every worker's current chunk params back into one tree
        (the single-program layout, CPU tensors) — checkpoint/parity
        surface."""
        from ray_tpu_torch.models.pipelined import (
            merge_pipeline_stages_interleaved,
        )

        return merge_pipeline_stages_interleaved(
            [_torch_tree(pickle.loads(b)) for b in self._stage_shards()])

    # ------------------------------------------------------------------

    def save_checkpoint(self, directory: str):
        """Write a restore-compatible checkpoint: every stage worker
        reports its param shard (`get_params`), the driver persists one
        shard file per stage plus a meta manifest. Pair with
        `load_pipeline_checkpoint` (reassembles the full single-program
        tree) and `CheckpointManager.register` for retention."""
        from ray_tpu_torch.train.checkpoint import Checkpoint

        os.makedirs(directory, exist_ok=True)
        for s, blob in enumerate(self._stage_shards()):
            with open(os.path.join(directory, f"stage_{s:04d}.pkl"),
                      "wb") as f:
                f.write(blob)
        meta = {
            "format": "pipeline-stage-shards-v1",
            "num_stages": self.num_stages,
            "num_repeats": self.num_repeats,
            "zero_stage": self.zero_stage,
            "data_parallel": self.data_parallel,
            "model": dataclasses.asdict(self.cfg),
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return Checkpoint(directory)

    def shutdown(self):
        if self.data_parallel > 1 and self.wg.workers:
            # the stage groups' processes may be reused: leave first
            try:
                self.wg.execute("leave_group", timeout=30)
            except Exception:  # noqa: BLE001
                pass
        self.wg.shutdown()


def load_pipeline_checkpoint(path: str):
    """Reassemble a `PipelineStrategy.save_checkpoint` directory into
    (full_params, meta): per-stage shard files merge back into the
    single-program param tree (CPU tensors), restore-compatible with
    both `PipelineStrategy(params=...)` (any stage/repeat split) and the
    in-program `pipelined_train_step`. Reads the JAX strategy's
    directories too (their shards are cloudpickled numpy trees, which
    the standard pickle loads)."""
    from ray_tpu_torch.models.pipelined import (
        merge_pipeline_stages_interleaved,
    )

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    chunks = []
    for s in range(int(meta["num_stages"])):
        with open(os.path.join(path, f"stage_{s:04d}.pkl"), "rb") as f:
            chunks.append(_torch_tree(pickle.load(f)))
    return merge_pipeline_stages_interleaved(chunks), meta
