"""User-facing tracing: nested in-task spans + trace-context access.

Reference parity: ray.util.tracing (tracing_helper.py:34 span
propagation), minus the OpenTelemetry dependency — spans land in the
process's TaskEventLog and flow to the head's cluster-wide span buffer,
so `ray_tpu_torch.timeline()` shows them on the merged timeline next to
the runtime's own task/actor spans. The port's copy of
``ray_tpu/util/tracing.py``; its `profiler_capture` arms
`torch.profiler` in place of `jax.profiler`, and the XLA compile probes
(`jit_cache_size`, `note_compile_if_grew`) are left out: the port
compiles no program.

    from ray_tpu_torch.util import tracing

    with tracing.span("preprocess"):          # inside a task, a driver,
        with tracing.span("tokenize"):        # or plain local code
            ...

Entering a span makes it the CURRENT trace context: tasks/actor calls
submitted inside it carry a child context, so a whole driver→actor→task
chain shares one trace_id (correlate with the `args` on timeline spans).
Works without an initialized runtime too (bench scripts, bare engines):
spans then collect in a process-local fallback log that `dump()`
exports."""

from __future__ import annotations

import contextlib
import threading
import time

from ray_tpu_torch.utils.events import TaskEventLog, child_trace

# spans recorded before/without ray_tpu_torch.init() (a bare LLMEngine)
_fallback_log = TaskEventLog()
_fallback_ctx = threading.local()


def _runtime():
    from ray_tpu_torch.core import api

    return api._runtime


def _ctx_and_log():
    rt = _runtime()
    if rt is not None and hasattr(rt, "_ctx") and hasattr(rt, "_events"):
        return rt._ctx, rt._events
    return _fallback_ctx, _fallback_log


def current_trace() -> dict | None:
    """The active {trace_id, span_id, parent_id} context, if any."""
    ctx, _ = _ctx_and_log()
    return getattr(ctx, "trace", None)


@contextlib.contextmanager
def span(name: str, category: str = "user"):
    """Record a span around the enclosed block and make it the current
    trace context (children — nested spans, submitted tasks, actor
    calls — link to it). Yields the span's trace context."""
    ctx, log = _ctx_and_log()
    parent = getattr(ctx, "trace", None)
    trace = child_trace(parent)
    ctx.trace = trace
    try:
        with log.span(name, category, trace=trace):
            yield trace
    finally:
        ctx.trace = parent


def record_span(name: str, duration_s: float, category: str = "user",
                trace: dict | None = None) -> None:
    """Log an already-measured span ending now (for code that timed
    itself — compile hooks, collective wrappers)."""
    _, log = _ctx_and_log()
    t1 = time.monotonic_ns()
    log.record(name, category, t1 - int(duration_s * 1e9), t1,
               trace=trace or current_trace())


def record_interval(name: str, t0_monotonic_s: float,
                    t1_monotonic_s: float, category: str = "user",
                    trace: dict | None = None) -> None:
    """Log a span over an explicit [t0, t1] monotonic-seconds window
    (time.monotonic() readings) — how waterfall producers lay phase
    spans at their true positions instead of 'ending now'."""
    _, log = _ctx_and_log()
    log.record(name, category, int(t0_monotonic_s * 1e9),
               int(t1_monotonic_s * 1e9), trace=trace or current_trace())


def configure_sampling(policy: dict | None) -> None:
    """Install a span sampling policy on this process's active span log
    (``{"max_per_s": N, "categories": {cat: N}}``, 0 = unlimited)."""
    _, log = _ctx_and_log()
    log.configure_sampling(policy)


@contextlib.contextmanager
def profiler_capture(out_dir: str | None, device="cuda"):
    """Arm a `torch.profiler` window (CUDA activity) around the
    enclosed block — the device-side profile that attributes in-kernel
    time (K1-K4 vs. GEMM vs. copy) the host-side span plane cannot see.
    On exit it writes a chrome trace into `out_dir`
    (``trace-<pid>-<n>.json``) and yields that file's path.

    A no-op (yields None) when `out_dir` is falsy or `device` is a CPU
    device, so drivers call it unconditionally. On a CUDA device it
    raises when the card is absent or the profiler cannot be armed: the
    JAX package yields None there, a fallback that would hide the
    device. The capture window rides the span API: a `profiler.capture`
    span (category `profiler`) covers the armed block, and its trace
    args carry the capture path."""
    if not out_dir or str(device).split(":")[0] == "cpu":
        # free no-op: torch.profiler is not imported
        yield None
        return
    import os

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"profiler_capture(device={device!r}): no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    global _capture_seq
    _capture_seq += 1
    path = os.path.join(out_dir,
                        f"trace-{os.getpid()}-{_capture_seq}.json")
    # the device's activity alone: tracing every host operator as well
    # more than doubles a train step's wall time
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    with span("profiler.capture", category="profiler") as trace:
        trace["capture_path"] = path
        try:
            yield path
        finally:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)


_capture_seq = 0


def dump(filename: str):
    """Write this process's trace to `filename`: the merged cluster
    timeline when a runtime is initialized, else the fallback log
    (scripts without a cluster)."""
    rt = _runtime()
    if rt is not None and hasattr(rt, "timeline"):
        return rt.timeline(filename)
    return _fallback_log.chrome_trace(filename)
