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
import re
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
    args carry the capture path.

    It also raises, after the export, when the trace holds fewer events
    of one of the port's kernels than the block launched (their launch
    counters moved): a profiler that is blind to the card, or to part of
    it, would otherwise hand back a trace that lacks those kernels.

    Inside the window a backward runs on the thread that armed the
    profiler, not on the autograd engine's device thread as it does
    unprofiled, so a profiled step's host times and spans are those of
    that single-threaded backward. Once, on an H100, a window lost the
    records of every kernel launched from the engine's device thread
    (all of a GPT-2 step's backward kernels; its forward's, launched
    from the arming thread, were kept). That loss did not come back in
    later runs with or without this setting, so nothing shows that the
    setting prevents it; why the records went missing is not known."""
    if not out_dir or str(device).split(":")[0] == "cpu":
        # free no-op: torch.profiler is not imported
        yield None
        return
    import os
    import warnings

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"profiler_capture(device={device!r}): no CUDA device")
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(out_dir, exist_ok=True)
    global _capture_seq
    _capture_seq += 1
    path = os.path.join(out_dir,
                        f"trace-{os.getpid()}-{_capture_seq}.json")
    launched0 = _kernel_launches()
    # the device's activity alone: tracing every host operator as well
    # more than doubles a train step's wall time. The window opens after
    # a warm-up step of the profiler's schedule, whose records are
    # dropped: without it the records of a window's first kernels go
    # missing from the trace, more of them the older the process (0 at
    # a minute, 7-19 after five on an H100), and a short window loses
    # them all
    with warnings.catch_warnings():  # that a new cycle clears events
        warnings.simplefilter("ignore", UserWarning)
        prof = profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1),
                       on_trace_ready=lambda p: p.export_chrome_trace(path))
    prof.__enter__()
    _warm_up(torch, device)
    prof.step()
    with span("profiler.capture", category="profiler") as trace:
        trace["capture_path"] = path
        try:
            with torch.autograd.set_multithreading_enabled(False):
                yield path
        finally:
            torch.cuda.synchronize()
            prof.step()  # the active step ends: the trace is exported
            prof.__exit__(None, None, None)
    launched = {k: n - launched0[k]
                for k, n in _kernel_launches().items()}
    recorded = kernel_events(path)
    lost = {k: n - recorded[k] for k, n in launched.items()
            if recorded[k] < n}
    if lost:
        what = ("no device event" if not device_events(path) else
                f"{sum(recorded.values())} of them")
        raise RuntimeError(
            f"profiler_capture: the block launched the port's kernels "
            f"{launched} but the trace {path} holds {what}: torch.profiler "
            f"lost the device records of {lost}")


_capture_seq = 0
WARM_UP_KERNELS = 256


def _warm_up(torch, device) -> None:
    """The profiler schedule's warm-up step: WARM_UP_KERNELS one-element
    kernels on `device`, then a synchronize."""
    x = torch.zeros(1, device=device)
    for _ in range(WARM_UP_KERNELS):
        x.add_(1)
    torch.cuda.synchronize()


# chrome-trace categories of the device's own activity (Kineto's names)
DEVICE_EVENT_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels' symbols in a chrome trace, by launch counter
PORT_KERNELS = {
    "flash_fwd": re.compile(r"\bflash_fwd_(?:f32|bf16|mma)_kernel\b"),
    "flash_dq": re.compile(r"\bflash_dq_(?:f32|bf16|mma)_kernel\b"),
    "flash_dkv": re.compile(r"\bflash_dkv_(?:f32|bf16|mma)_kernel\b"),
    "paged_attention": re.compile(r"\bpaged_kernel\b"),
}


def _kernel_launches() -> dict[str, int]:
    """Launches of each of the port's kernels in this process so far."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    return {c.name: c.count for c in (fa.LAUNCHES, fa.LAUNCHES_DQ,
                                      fa.LAUNCHES_DKV, pa.LAUNCHES)}


def _trace_events(path: str) -> list:
    import json

    with open(path) as f:
        trace = json.load(f)
    return trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace


def device_events(path: str) -> int:
    """The device events (kernels, copies, memsets) of a chrome trace
    that `profiler_capture` wrote."""
    return sum(1 for e in _trace_events(path)
               if e.get("cat") in DEVICE_EVENT_CATEGORIES)


def kernel_events(path: str) -> dict[str, int]:
    """The kernel events of each of the port's kernels in a chrome trace
    that `profiler_capture` wrote, by launch counter."""
    out = dict.fromkeys(PORT_KERNELS, 0)
    for e in _trace_events(path):
        if e.get("cat") != "kernel":
            continue
        for k, sym in PORT_KERNELS.items():
            if sym.search(e.get("name", "")):
                out[k] += 1
    return out


def dump(filename: str):
    """Write this process's trace to `filename`: the merged cluster
    timeline when a runtime is initialized, else the fallback log
    (scripts without a cluster)."""
    rt = _runtime()
    if rt is not None and hasattr(rt, "timeline"):
        return rt.timeline(filename)
    return _fallback_log.chrome_trace(filename)
