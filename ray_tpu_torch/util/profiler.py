"""Profiler plane — in-process sampling profiler + collapsed-stack
plumbing.

Reference parity: Ray ships cluster profiling as first-class state-API
tooling (`ray stack` / per-worker py-spy capture in the dashboard,
`ray memory` for object attribution). The two biggest recent perf wins
here (the ~100us `os.urandom` submit tax, the traceback-pinned
stranded-ObjectRef leak) were found by *ad-hoc* profiling; this module
mechanizes that: every process can answer "where are your threads right
now, statistically" on demand.

Design:

- **Dormant by default.** No thread exists until a capture window is
  armed; an unarmed process pays literally nothing. A `StackSampler`
  *is* one capture window: construct, `start()`, work, `stop()`,
  `collapsed()`. The sampling thread walks `sys._current_frames()` at
  `hz`, excluding itself, and aggregates root-first `;`-joined stacks
  into a bounded dict of collapsed-stack counts — samples landing past
  the unique-stack cap are dropped AND counted (`stacks_dropped`),
  never silently lost. The sampler records its own CPU cost
  (`cpu_seconds`, via `time.thread_time`) so the <2% overhead contract
  is a measured number, not a hope.
- **Wall-clock sampling.** Every thread is sampled, including parked
  ones — "32 handler threads in `queue.get`" is exactly the signal an
  operator wants when asking why a node is idle. CPU-only attribution
  is the separate per-task `time.thread_time` accounting in the worker
  exec loop (`core_task_cpu_seconds_total{kind}` +
  `util.state.cpu_attribution()`).
- **Collapsed format.** `stack count` lines (`collapsed_text`) are
  directly consumable by flamegraph.pl / speedscope / inferno. Cluster
  merges prefix each page with `node:<id>`/`proc:<id>` pseudo-frames
  (`prefix_stacks` + `merge_collapsed`), so one flamegraph splits by
  node, then process, then code.
- **Capture windows are cheap but not free** (a sample costs one GIL
  grab + a frame walk), so captures are explicitly armed per window —
  by the `profile_capture` RPC fan-out (`util.state.profile`), a bench
  driver's `--profile` flag (`capture_to_file`), or the debug-dump
  flight recorder — and bounded by `MAX_CAPTURE_S`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

DEFAULT_HZ = 25.0
MAX_CAPTURE_S = 60.0
MAX_UNIQUE_STACKS = 2000
MAX_DEPTH = 48


def _frame_label(frame) -> str:
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class StackSampler:
    """One capture window over this process's threads.

    Not reusable: arm with `start()`, end with `stop()`, read
    `collapsed()`/`samples`/`stacks_dropped`/`cpu_seconds`. Dormant
    processes hold no instance at all — the daemon thread exists only
    between start() and stop()."""

    def __init__(self, hz: float | None = None,
                 max_unique_stacks: int | None = None,
                 max_depth: int = MAX_DEPTH):
        self.hz = float(hz) if hz else DEFAULT_HZ
        self.max_unique_stacks = int(max_unique_stacks or
                                     MAX_UNIQUE_STACKS)
        self.max_depth = max_depth
        self._stacks: dict[str, int] = {}  # guarded_by(_lock)
        self._lock = threading.Lock()
        self.samples = 0  # sample ticks taken (all threads each tick)
        self.stacks_dropped = 0  # thread-samples rejected by the cap
        self.cpu_seconds = 0.0  # the sampler thread's own CPU cost
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "StackSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="stack-sampler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        cpu0 = time.thread_time()
        next_t = time.monotonic()
        while not self._stop.is_set():
            # one GIL-holding pass: snapshot every thread's top frame,
            # walk to the roots OUTSIDE any locks of ours
            frames = sys._current_frames()
            tick: list[str] = []
            for tid, frame in frames.items():
                if tid == me:
                    continue
                parts = []
                f = frame
                while f is not None and len(parts) < self.max_depth:
                    parts.append(_frame_label(f))
                    f = f.f_back
                parts.reverse()  # root first — the collapsed convention
                tick.append(";".join(parts))
            del frames
            with self._lock:
                self.samples += 1
                for s in tick:
                    cur = self._stacks.get(s)
                    if cur is not None:
                        self._stacks[s] = cur + 1
                    elif len(self._stacks) < self.max_unique_stacks:
                        self._stacks[s] = 1
                    else:
                        self.stacks_dropped += 1
            # drift-corrected tick; when sampling falls behind (GIL
            # contention), re-anchor instead of bursting to catch up
            next_t += period
            delay = next_t - time.monotonic()
            if delay <= 0:
                next_t = time.monotonic()
            elif self._stop.wait(delay):
                break
        self.cpu_seconds = time.thread_time() - cpu0

    def collapsed(self) -> dict[str, int]:
        """{root-first `;`-joined stack: sample count}."""
        with self._lock:
            return dict(self._stacks)


def _note_capture(sampler: StackSampler) -> None:
    """Account a finished capture window in the process metrics page."""
    try:
        from ray_tpu_torch.util.metrics import Counter

        Counter("profile_captures_total",
                "Sampling-profiler capture windows completed").inc()
        Counter("profile_samples_total",
                "Stack sample ticks taken across capture windows"
                ).inc(sampler.samples)
        if sampler.stacks_dropped:
            Counter("profile_stacks_dropped_total",
                    "Thread-samples rejected by the unique-stack cap"
                    ).inc(sampler.stacks_dropped)
    except Exception:  # noqa: BLE001
        pass  # metrics are a rider, never a capture failure


def capture_collapsed(duration_s: float, hz: float | None = None,
                      max_unique_stacks: int | None = None) -> dict:
    """Blocking capture of THIS process: arm a sampler, sleep the
    window, return ``{"stacks", "samples", "dropped", "hz",
    "duration_s"}``. The unit every `profile_capture` RPC handler
    serves — the handler thread sleeping IS the capture window."""
    duration_s = max(0.05, min(float(duration_s), MAX_CAPTURE_S))
    s = StackSampler(hz=hz, max_unique_stacks=max_unique_stacks).start()
    try:
        time.sleep(duration_s)
    finally:
        s.stop()
    _note_capture(s)
    return {"stacks": s.collapsed(), "samples": s.samples,
            "dropped": s.stacks_dropped, "hz": s.hz,
            "duration_s": duration_s}


@contextlib.contextmanager
def accumulate(stacks: dict | None, hz: float | None = None):
    """Arm a sampler around the enclosed block and merge its collapsed
    stacks into `stacks` IN PLACE — the bench drivers' measured-window
    hook (arm per window, accumulate across windows, write once at the
    end). ``stacks=None`` is a genuinely free no-op: nothing is
    constructed."""
    if stacks is None:
        yield None
        return
    s = StackSampler(hz=hz).start()
    try:
        yield s
    finally:
        s.stop()
        _note_capture(s)
        for k, n in s.collapsed().items():
            stacks[k] = stacks.get(k, 0) + n


@contextlib.contextmanager
def capture_to_file(path: str | None, hz: float | None = None):
    """Arm a sampler around the enclosed block and write the collapsed
    output to `path` (the bench drivers' `--profile` shape). A falsy
    path is a genuinely free no-op — nothing is constructed, matching
    the step-waterfall one-bool discipline."""
    if not path:
        yield None
        return
    s = StackSampler(hz=hz).start()
    try:
        yield s
    finally:
        s.stop()
        _note_capture(s)
        write_collapsed(path, s.collapsed())


# ------------------------------------------------------------------ merging

def prefix_stacks(stacks: dict[str, int], prefix: str) -> dict[str, int]:
    """Prepend origin pseudo-frames (``node:<id>`` / ``proc:<id>``) so
    merged flamegraphs split by origin before code."""
    return {f"{prefix};{s}": n for s, n in stacks.items()}


def merge_collapsed(pages: list[dict]) -> dict[str, int]:
    """Sum collapsed-stack pages; identical stacks accumulate."""
    out: dict[str, int] = {}
    for page in pages:
        for s, n in page.items():
            out[s] = out.get(s, 0) + n
    return out


def collapsed_text(stacks: dict[str, int]) -> str:
    """Flamegraph-compatible `.collapsed` text: one ``stack count``
    line per unique stack, heaviest first (deterministic: ties break
    on the stack string)."""
    lines = [f"{s} {n}" for s, n in
             sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines) + ("\n" if lines else "")


def write_collapsed(path: str, stacks: dict[str, int]) -> str:
    with open(path, "w") as f:
        f.write(collapsed_text(stacks))
    return path


def collapsed_to_chrome(stacks: dict[str, int], hz: float,
                        filename: str | None = None):
    """Convert merged collapsed stacks to a chrome trace laid out on
    a synthetic timeline: pid = node pseudo-frame, tid = proc
    pseudo-frame, one ``X`` event per unique stack whose duration is
    its sampled share (count / hz), laid heaviest-first per track.
    Not a real time axis — a flamegraph-by-area view that opens in the
    same chrome://tracing / perfetto page as the merged timeline."""
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    meta: list[dict] = []
    events: list[dict] = []
    cursor: dict[tuple, float] = {}
    per_sample_us = 1e6 / max(hz, 1e-9)
    for stack, count in sorted(stacks.items(),
                               key=lambda kv: (-kv[1], kv[0])):
        frames = stack.split(";")
        node = "local"
        proc = "main"
        while frames and (frames[0].startswith("node:")
                          or frames[0].startswith("proc:")):
            tag = frames.pop(0)
            if tag.startswith("node:"):
                node = tag[5:]
            else:
                proc = tag[5:]
        pid = pids.get(node)
        if pid is None:
            pid = pids[node] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "args": {"name": f"node:{node[:16]}"}})
        tkey = (pid, proc)
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = len(tids) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": proc[:16]}})
        ts = cursor.get(tkey, 0.0)
        dur = count * per_sample_us
        cursor[tkey] = ts + dur
        events.append({
            "name": frames[-1] if frames else "(empty)",
            "cat": "profile", "ph": "X", "ts": ts, "dur": dur,
            "pid": pid, "tid": tid,
            "args": {"stack": ";".join(frames), "samples": count}})
    out = meta + events
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(out, f)
        return filename
    return out
