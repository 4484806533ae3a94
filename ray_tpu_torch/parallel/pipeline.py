"""Pipeline parallelism: the 1F1B schedule math of the worker-group
strategy, and the in-program GPipe and interleaved schedules over the
``pipe`` mesh axis.

The port of ``ray_tpu/parallel/pipeline.py``. The schedule helpers are
pure Python there and are copied here under the same names, so the port
needs nothing of the JAX package. `pipeline_apply` and
`pipeline_apply_interleaved` run inside the port's `shard_map` (which
makes the mesh ambient), on this rank's stage slice of the stacked stage
params, and move activations with the port's `ppermute` and gather the
result with its `psum` (``parallel/ops.py``).

Deviations, neither of which changes a value:

- a Python loop over the schedule's ticks takes the place of
  ``lax.scan``; autograd records every tick;
- ``lax.axis_index`` is a host int here, but a choice that depends on it
  (which stage ingests a microbatch, which emits one, which repeat a
  device runs) stays an operator (``torch.where`` on a one-element
  condition, a one-hot slot mask for ``.at[i].add`` and ``.at[i].set``)
  and never becomes a Python branch: every rank then records the same
  autograd graph, so the backward's point-to-point sends and sums meet
  on every rank in the same order. A branch taken on one stage and not
  on another would leave a send without its receive.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.ops import (
    axis_index as _axis_index,
    axis_size as _axis_size,
    ppermute,
    psum,
)
from ray_tpu_torch.parallel.sharding import replicate_like
from ray_tpu_torch.util import tree


# ---------------------------------------------------------------------------
# 1F1B (MPMD) schedule — the worker-group strategy's timetable
# ---------------------------------------------------------------------------
#
# The in-program schedules below run every stage on every device inside
# one SPMD program. The MPMD alternative ("Scaling Deep Learning
# Training with MPMD Pipeline Parallelism") gives each STAGE its own
# worker process and streams activations between them; the classic
# one-forward-one-backward (1F1B) order keeps at most (S - s) live
# activations on stage s while reaching the same (S-1)/(S-1+M) bubble
# as GPipe. These helpers are pure schedule math — data, not lax — so
# the driver (train/pipeline_strategy.py) can submit actor calls in
# exactly this order and a unit test can pin the interleave.


def one_f_one_b_schedule(num_stages: int, num_microbatches: int
                         ) -> list[list[tuple[str, int]]]:
    """Per-stage 1F1B op order: result[s] is the exact sequence of
    ("fwd"|"bwd", microbatch) ops stage s executes. Stage s warms up
    with min(M, S-1-s) forwards, alternates fwd/bwd through the steady
    state, then drains the remaining backwards — the Megatron
    schedules.py order, as a list."""
    S, M = num_stages, num_microbatches
    if S < 1 or M < 1:
        raise ValueError(f"need stages >= 1 and microbatches >= 1, "
                         f"got {S}, {M}")
    sched: list[list[tuple[str, int]]] = []
    for s in range(S):
        warm = min(M, S - 1 - s)
        ops = [("fwd", m) for m in range(warm)]
        for i in range(M - warm):
            ops.append(("fwd", warm + i))
            ops.append(("bwd", i))
        for m in range(M - warm, M):
            ops.append(("bwd", m))
        sched.append(ops)
    return sched


def one_f_one_b_submission_order(num_stages: int, num_microbatches: int
                                 ) -> list[tuple[str, int, int]]:
    """Global topological submission order for the 1F1B schedule:
    (kind, stage, microbatch) triples such that every op appears after
    its dependencies — fwd(s,m) after fwd(s-1,m); bwd(s,m) after
    fwd(s,m) and bwd(s+1,m) — while each stage's own ops appear in its
    `one_f_one_b_schedule` order. A driver submitting actor calls in
    this order can wire every call's inputs to already-created object
    refs, and per-actor FIFO execution then IS the 1F1B interleave."""
    S, M = num_stages, num_microbatches
    per_stage = one_f_one_b_schedule(S, M)
    ptr = [0] * S
    emitted: set[tuple[str, int, int]] = set()
    order: list[tuple[str, int, int]] = []
    remaining = sum(len(ops) for ops in per_stage)
    while len(order) < remaining:
        progressed = False
        for s in range(S):
            while ptr[s] < len(per_stage[s]):
                kind, m = per_stage[s][ptr[s]]
                deps = []
                if kind == "fwd" and s > 0:
                    deps.append(("fwd", s - 1, m))
                if kind == "bwd":
                    deps.append(("fwd", s, m))
                    if s < S - 1:
                        deps.append(("bwd", s + 1, m))
                if not all(d in emitted for d in deps):
                    break
                op = (kind, s, m)
                order.append(op)
                emitted.add(op)
                ptr[s] += 1
                progressed = True
        if not progressed:
            raise RuntimeError(  # unreachable: 1F1B is deadlock-free
                f"1F1B submission stalled at {ptr} for S={S} M={M}")
    return order


def simulate_1f1b(num_stages: int, num_microbatches: int,
                  fwd_ticks: float = 1.0, bwd_ticks: float = 1.0) -> dict:
    """Discrete-event simulation of the 1F1B schedule with fixed op
    costs: returns {"makespan", "busy", "bubble_ratio"} where
    bubble_ratio = 1 - busy / (S * makespan). With fwd == bwd cost this
    reproduces the textbook (S-1)/(S-1+M) bubble exactly — the
    theoretical floor the strategy's measured bubble is compared to."""
    S, M = num_stages, num_microbatches
    per_stage = one_f_one_b_schedule(S, M)
    cost = {"fwd": fwd_ticks, "bwd": bwd_ticks}
    done: dict[tuple[str, int, int], float] = {}
    free = [0.0] * S
    for kind, s, m in one_f_one_b_submission_order(S, M):
        deps = []
        if kind == "fwd" and s > 0:
            deps.append(("fwd", s - 1, m))
        if kind == "bwd":
            deps.append(("fwd", s, m))
            if s < S - 1:
                deps.append(("bwd", s + 1, m))
        start = max([free[s]] + [done[d] for d in deps])
        free[s] = done[(kind, s, m)] = start + cost[kind]
    makespan = max(free)
    busy = sum(cost[k] for ops in per_stage for k, _ in ops)
    return {"makespan": makespan, "busy": busy,
            "bubble_ratio": 1.0 - busy / (S * makespan)}


def theoretical_bubble(num_stages: int, num_microbatches: int) -> float:
    """(S-1)/(S-1+M): the 1F1B/GPipe pipeline-fill bubble fraction."""
    S, M = num_stages, num_microbatches
    return (S - 1) / (S - 1 + M) if S > 1 else 0.0


# ---------------------------------------------------------------------------
# Interleaved (circular) 1F1B over worker groups — virtual pipeline stages
# ---------------------------------------------------------------------------
#
# The MPMD counterpart of `pipeline_apply_interleaved`: split the model
# into V = S*R VIRTUAL stages placed round-robin (virtual stage v lives
# on worker v % S, repeat slot v // S). Each fwd/bwd op now costs ~1/R of
# a flat-stage op while total per-worker compute is unchanged, so the
# pipeline fill/drain — the only idle time — shrinks by the same factor:
#
#   bubble = (S-1) / (R*M + S-1)        vs flat  (S-1) / (M + S-1)
#
# strictly lower for R >= 2 whenever M >= S (the circular schedule's
# causality condition, same as pipeline_apply_interleaved). The ticks:
# fwd of (r, s, m) at tick r*M + m + s; the backward pass mirrors the
# forward circle, bwd of (r, s, m) at F + (R-1-r)*M + m + (S-1-s) with
# F = R*M + S - 1. Both passes are conflict-free (one op per worker per
# tick) and dependency-safe for M >= S; a driver submitting actor calls
# in tick order onto FIFO workers realizes exactly this timetable.


def interleaved_1f1b_submission_order(num_stages: int, num_microbatches: int,
                                      num_repeats: int
                                      ) -> list[tuple[str, int, int]]:
    """Global topological submission order for the circular interleaved
    schedule: (kind, virtual_stage, microbatch) triples with
    virtual_stage in [0, S*R); the owning worker is virtual_stage % S
    and its repeat slot is virtual_stage // S. Dependencies — fwd(v,m)
    after fwd(v-1,m); bwd(v,m) after fwd(v,m) and bwd(v+1,m) — are
    satisfied in order, so per-worker FIFO execution IS the schedule.
    With num_repeats == 1 this degrades to a valid flat 1F1B-shaped
    order (all-forward-then-backward per microbatch wave)."""
    S, M, R = num_stages, num_microbatches, num_repeats
    if S < 1 or M < 1 or R < 1:
        raise ValueError(f"need stages/microbatches/repeats >= 1, "
                         f"got {S}, {M}, {R}")
    if M < S:
        raise ValueError(
            f"interleaved schedule needs microbatches {M} >= stages {S}")
    F = R * M + S - 1  # forward-phase tick count
    ops: list[tuple[int, int, str, int, int]] = []
    for r in range(R):
        for m in range(M):
            for s in range(S):
                v = r * S + s
                ops.append((r * M + m + s, s, "fwd", v, m))
                ops.append((F + (R - 1 - r) * M + m + (S - 1 - s),
                            s, "bwd", v, m))
    ops.sort()
    return [(kind, v, m) for _, _, kind, v, m in ops]


def simulate_interleaved_1f1b(num_stages: int, num_microbatches: int,
                              num_repeats: int, fwd_ticks: float = 1.0,
                              bwd_ticks: float = 1.0) -> dict:
    """Discrete-event simulation of the circular interleaved schedule
    with per-VIRTUAL-stage op costs of fwd_ticks/R and bwd_ticks/R (the
    model is the same size — each chunk is 1/R of a flat stage). With
    fwd == bwd cost this reproduces (S-1)/(R*M + S-1) exactly, the floor
    the strategy's measured bubble is compared to. Same keys as
    `simulate_1f1b` so callers can A/B the two."""
    S, M, R = num_stages, num_microbatches, num_repeats
    V = S * R
    cost = {"fwd": fwd_ticks / R, "bwd": bwd_ticks / R}
    done: dict[tuple[str, int, int], float] = {}
    free = [0.0] * S
    busy = 0.0
    for kind, v, m in interleaved_1f1b_submission_order(S, M, R):
        w = v % S
        deps = []
        if kind == "fwd" and v > 0:
            deps.append(("fwd", v - 1, m))
        if kind == "bwd":
            deps.append(("fwd", v, m))
            if v < V - 1:
                deps.append(("bwd", v + 1, m))
        start = max([free[w]] + [done[d] for d in deps])
        free[w] = done[(kind, v, m)] = start + cost[kind]
        busy += cost[kind]
    makespan = max(free)
    return {"makespan": makespan, "busy": busy,
            "bubble_ratio": 1.0 - busy / (S * makespan)}


def theoretical_bubble_interleaved(num_stages: int, num_microbatches: int,
                                   num_repeats: int) -> float:
    """(S-1)/(R*M + S-1): the circular interleaved-1F1B bubble fraction
    — flat `theoretical_bubble` divided by ~R at equal S and M."""
    S, M, R = num_stages, num_microbatches, num_repeats
    return (S - 1) / (R * M + S - 1) if S > 1 else 0.0


def _where(cond: bool, a, b):
    """``jnp.where`` on a condition the host knows: the operator runs on
    every rank whatever the condition (see the module's deviations)."""
    c = replicate_like(torch.tensor(bool(cond), device=a.device), a)
    return torch.where(c, a, b)


def _slot(n: int, i: int, like, on: bool = True):
    """(n, 1, ..) bool mask of slot i of a stack shaped like `like`'s
    leading dim, all False when not `on`: ``stack.at[i]`` as an
    operator."""
    mask = (torch.arange(n, device=like.device) == i) & bool(on)
    mask = mask.view(n, *([1] * (like.dim() - 1)))
    return replicate_like(mask, like)


def pipeline_apply(stage_fn, stage_params, x, axis_name: str = "pipe",
                   num_microbatches: int | None = None) -> torch.Tensor:
    """Run `stage_fn(params_i, h) -> h` for stages i = 0..S-1 as a
    pipeline over the `axis_name` mesh axis.

    Inside shard_map: `stage_params` is THIS rank's stage slice (the
    caller shards the stacked stage dim), `x` is the full batch
    (replicated along the pipe axis), split into `num_microbatches`
    equal microbatches along dim 0. Returns the full output batch.
    """
    S = _axis_size(axis_name)
    stage = _axis_index(axis_name)
    B = x.shape[0]
    M = num_microbatches or S
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    mb = B // M
    micro = x.reshape(M, mb, *x.shape[1:])

    n_ticks = M + S - 1
    # right-rotation by one hop: stage i sends to stage i+1
    shift_perm = [(i, (i + 1) % S) for i in range(S)]

    held = torch.zeros_like(micro[0])
    outputs = torch.zeros_like(micro)
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (when in range); other stages
        # keep what arrived from their left neighbor
        feed = micro[min(max(t, 0), M - 1)]
        held = _where(stage == 0,
                      _where(t < M, feed, torch.zeros_like(feed)), held)
        out = stage_fn(stage_params, held)
        # last stage emits microbatch (t - S + 1) when in range
        m_out = t - (S - 1)
        emit = stage == S - 1 and 0 <= m_out < M
        outputs = outputs + torch.where(
            _slot(M, min(max(m_out, 0), M - 1), outputs, emit),
            out[None], 0.0)
        held = ppermute(out, axis_name, shift_perm)
    # outputs were produced only on the last stage; share them with every
    # pipe rank so the result is replicated along the axis (psum over a
    # one-hot contribution)
    outputs = psum(_where(stage == S - 1, outputs,
                          torch.zeros_like(outputs)), axis_name)
    return outputs.reshape(B, *x.shape[1:])


def pipeline_apply_interleaved(stage_fn, stage_params, x,
                               axis_name: str = "pipe",
                               num_microbatches: int | None = None,
                               num_repeats: int = 1) -> torch.Tensor:
    """Interleaved (circular) pipeline schedule, Megatron's interleaved
    1F1B in one program (MaxText's circular pipeline). Each rank holds
    `num_repeats` VIRTUAL stages (round-robin placement: rank s owns
    virtual stages s, s+S, ..), so the per-rank bubble drops from
    (S-1)/M to (S-1)/(R*M); autograd's backward runs the mirrored
    schedule.

    Schedule (M microbatches, S ranks, R repeats, V = S*R virtual
    stages): microbatch m enters repeat r at tick r*M + m; at tick t,
    rank s processes microbatch (t - s) mod M at repeat (t - s) // M,
    one stage-execution per rank per tick. Activations leaving the last
    rank park in a circular buffer until their next repeat's entry tick.
    Total ticks R*M + S - 1.

    `stage_params` is THIS rank's (R, ...) stack of virtual-stage params
    (the caller shards the (V, ...) stack over `axis_name` in
    round-robin order: virtual stage v lives at rank v % S, slot
    v // S). Requires M >= S, which keeps the buffer causal.
    """
    S = _axis_size(axis_name)
    stage = _axis_index(axis_name)
    R = num_repeats
    B = x.shape[0]
    M = num_microbatches or S
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    assert M >= S, f"interleaved schedule needs microbatches {M} >= stages {S}"
    mb = B // M
    micro = x.reshape(M, mb, *x.shape[1:])

    n_ticks = R * M + S - 1
    shift_perm = [(i, (i + 1) % S) for i in range(S)]

    held = torch.zeros_like(micro[0])
    circ = torch.zeros_like(micro)
    outputs = torch.zeros_like(micro)
    for t in range(n_ticks):
        # rank s works on microbatch m=(t-s) mod M, repeat r=(t-s)//M
        age = t - stage
        m = age % M
        r = min(max(age // M, 0), R - 1)
        active = 0 <= age < R * M
        # stage 0 ingest: fresh microbatch on repeat 0, parked wrap after
        feed = _where(age < M, micro[m], circ[m])
        held = _where(stage == 0, feed, held)
        params_r = tree.tree_map(lambda p: p[r], stage_params)
        out = _where(active, stage_fn(params_r, held),
                     torch.zeros_like(held))
        # last stage at a non-final repeat: the activation wraps, reaches
        # stage 0 next tick and parks in circ until its entry tick
        # (r+1)*M + m; slot m == (arrival_tick - S) mod M
        emit_final = stage == S - 1 and active and r == R - 1
        outputs = outputs + torch.where(_slot(M, m, outputs, emit_final),
                                        out[None], 0.0)
        held = ppermute(out, axis_name, shift_perm)
        park = stage == 0 and t + 1 >= S
        circ = torch.where(_slot(M, (t + 1 - S) % M, circ, park),
                           held[None], circ)
    outputs = psum(_where(stage == S - 1, outputs,
                          torch.zeros_like(outputs)), axis_name)
    return outputs.reshape(B, *x.shape[1:])
