"""Structured logging plane — the fourth observability pillar.

Reference parity: Ray's log pipeline (a per-node log monitor tailing
worker files for the dashboard, `_private/log_monitor.py:103`;
worker-print-to-driver mirroring with `(pid, ip)` attribution in
`_private/worker.py print_logs`; the `ray logs` state-API surface) —
here rebuilt structured-first: every process emits bounded, rotated
JSONL records instead of opaque text, so "which replica logged this
error, on which trace, during which alert window" is a filter, not
archaeology.

Record contract (one JSON object per line):

    ts        epoch seconds, anchored like span timestamps (the span
              plane's contract: monotonic-timed, wall-stamped via the
              once-per-process offset — comparable across nodes)
    level     debug|info|warning|error|critical
    logger    the stdlib logger name ("" for stream captures)
    msg       the formatted message (bounded; see MAX_MSG_BYTES)
    source    "log" (a logging call) | "stdout" | "stderr" (captured
              raw prints, attributed to the executing task)
    node      node id (hex12), proc: worker id (hex12) / role name,
    role      worker|nodelet|driver|head,  pid: OS pid
    task      executing task id (hex) when one is active
    task_name task/actor-method label when one is active
    actor     hosting actor id (hex) for actor workers
    trace_id / span_id   the active tracing context — the key that
              joins log lines to the merged timeline and to request
              waterfalls

Every field beyond ts/level/msg is injected automatically: the handler
and the stream capture read the runtime's thread-local context at emit
time, so a task that calls ``logging.getLogger(...).error(...)`` or
plain ``print(...)`` gets task/trace attribution for free.

Write path discipline: the sink is two-file rotated JSONL (the
SpanSpill shape — append to the current file, rotate at half the byte
budget, total disk under ``RAY_TPU_LOG_MAX_BYTES``), counted through
``log_records_total{level}`` / ``log_bytes_total`` /
``log_records_dropped_total`` so a lossy log plane is a queryable
fact. The query path is the nodelet's ``log_query`` RPC over its log
dir (see core/nodelet.py) fanned out cluster-wide by the head's
``cluster_logs`` — surfaced as ``util.state.cluster_logs`` and the
``ray_tpu_torch.scripts.cli logs`` CLI.

Driver mirroring (``RAY_TPU_LOG_TO_DRIVER``, off by default): when
armed, captured worker prints are ALSO forwarded to the submitting
owner as ``driver_log`` oneways and printed there with a
``(task pid=…, node=…)`` prefix — the signature Ray ergonomic. The
hot path stays one bool: unarmed workers construct no mirror state
and pay only the structured emit per *printed line* (measured <1% of
an armed window, test-gated)."""

from __future__ import annotations

import io
import json
import logging
import os
import sys
import threading
import time

from ray_tpu_torch.utils.events import epoch_us

MAX_MSG_BYTES = 4096
LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40,
          "critical": 50}


def level_no(name: str) -> int:
    """Numeric rank of a level name (unknown names rank as info)."""
    return LEVELS.get(str(name).lower(), 20)


def _max_bytes() -> int:
    from ray_tpu_torch.core import config as cfg

    return cfg.get("LOG_MAX_BYTES")


# ---------------------------------------------------------------- sink

# one encoder for every record (`json.dumps` with `default=` builds a
# new one a call); the same output as json.dumps(record, default=str)
_ENCODER = json.JSONEncoder(default=str)


class LogSink:
    """Bounded two-file-rotated JSONL writer (the SpanSpill rotation
    shape: append to `<path>`, rotate to `<path>.1` once the current
    file crosses half the byte budget — total disk stays under
    `max_bytes`, the oldest half is what ages out, and no append ever
    rewrites a big file). A None path is a counting-only sink (records
    are metered, nothing hits disk). All I/O under a private lock;
    write() never raises."""

    def __init__(self, path: str | None, max_bytes: int | None = None):
        self.path = path
        self.max_bytes = max_bytes if max_bytes is not None \
            else _max_bytes()
        self._lock = threading.Lock()
        self._cur_bytes = 0  # guarded_by(_lock)
        self._fh = None  # guarded_by(_lock); lazily-(re)opened appender
        self.written = 0  # guarded_by(_lock)
        self.dropped = 0  # guarded_by(_lock)
        if path is not None:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._cur_bytes = os.path.getsize(path) \
                    if os.path.exists(path) else 0
            except OSError:
                self.path = None
        from ray_tpu_torch.util.metrics import Counter

        self._m_records = Counter(
            "log_records_total",
            "Structured log records emitted, by level",
            tag_keys=("level",))
        self._m_bytes = Counter(
            "log_bytes_total",
            "Structured log bytes written (JSONL, post-rotation "
            "accounting)")
        self._m_dropped = Counter(
            "log_records_dropped_total",
            "Structured log records lost (serialization or disk "
            "failure) — drops are counted, never silent")

    def write(self, record: dict) -> None:
        try:
            line = _ENCODER.encode(record) + "\n"
        except (TypeError, ValueError):
            with self._lock:
                self.dropped += 1
            self._m_dropped.inc()
            return
        blob = line.encode()
        if self.path is None:
            self._m_records.inc(
                tags={"level": record.get("level", "info")})
            self._m_bytes.inc(len(blob))
            with self._lock:
                self.written += 1
            return
        with self._lock:
            try:
                if self._fh is None:
                    # justified GL012: this lock exists to serialize
                    # exactly this append/rotate pair (concurrent
                    # writers would interleave half-lines into the
                    # JSONL). v2 index audit: the only acquisition it
                    # nests is metrics.Counter._lock (chain: LogSink.
                    # write -> Counter.inc), a leaf lock with no
                    # outgoing order edges, so no inversion is possible
                    # graftlint: disable=blocking-under-lock
                    # unbuffered: each record is one write(2), so the
                    # query path, which tails this file, sees it at once
                    self._fh = open(self.path, "ab", buffering=0)
                done = self._fh.write(blob)
                while done < len(blob):  # a short write(2): the rest
                    done += self._fh.write(blob[done:])
            except (OSError, ValueError):
                self._close_fh_locked()
                self.dropped += 1
                self._m_dropped.inc()
                return
            self.written += 1
            self._cur_bytes += len(blob)
            if self._cur_bytes > self.max_bytes // 2:
                self._close_fh_locked()
                try:
                    os.replace(self.path, self.path + ".1")
                except OSError:
                    pass
                self._cur_bytes = 0
        # counted AFTER the landing: a full disk must show up as
        # dropped-climbing/bytes-flat, not as both sides climbing
        self._m_records.inc(tags={"level": record.get("level", "info")})
        self._m_bytes.inc(len(blob))

    def _close_fh_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:  # noqa: BLE001
                pass
            self._fh = None


# ---------------------------------------------------------- attribution

_api = None  # ray_tpu_torch.core.api, imported at the first emit


def _runtime_attribution() -> dict:
    """Task/actor/trace identity of the CALLING thread, read from the
    runtime's thread-local context at emit time (the worker exec loop
    sets task_id/trace per execution, so log lines and raw prints from
    task code correlate with the task's span for free)."""
    global _api
    try:
        if _api is None:
            from ray_tpu_torch.core import api

            _api = api
        ctx = getattr(_api._runtime, "_ctx", None)
    except Exception:  # noqa: BLE001
        ctx = None
    if ctx is None:
        return {}
    out: dict = {}
    tid = getattr(ctx, "task_id", None)
    if tid is not None:
        out["task"] = tid.hex()
    name = getattr(ctx, "task_name", None)
    if name:
        out["task_name"] = name
    aid = getattr(ctx, "actor_id", None)
    if aid is not None:
        out["actor"] = aid.hex()
    trace = getattr(ctx, "trace", None)
    if trace:
        out["trace_id"] = trace.get("trace_id")
        out["span_id"] = trace.get("span_id")
    return out


# -------------------------------------------------------------- handler

class StructuredLogHandler(logging.Handler):
    """stdlib-logging → structured JSONL. Install once per process via
    `install_process_logging`; every `logging.getLogger(...)` call in
    that process then lands in the sink as a schema record with
    node/proc/task/trace attribution auto-injected."""

    def __init__(self, sink: LogSink, node: str = "", proc: str = "",
                 role: str = ""):
        super().__init__(level=0)
        self.sink = sink
        self.ident = {"node": node, "proc": proc, "role": role,
                      "pid": os.getpid()}

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001
            msg = str(record.msg)
        if record.exc_info and record.exc_info[1] is not None:
            msg = f"{msg}\n{record.exc_info[1]!r}"
        rec = {
            "ts": epoch_us() / 1e6,
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": msg[:MAX_MSG_BYTES],
            "source": "log",
            **self.ident,
            **_runtime_attribution(),
        }
        self.sink.write(rec)


# -------------------------------------------------------- stream capture

class StdStreamCapture(io.TextIOBase):
    """Wraps sys.stdout/sys.stderr in the worker: writes pass THROUGH
    to the real stream (the nodelet's `worker-*.log` redirect keeps its
    raw text), and every complete line is additionally emitted as a
    structured record attributed to the executing task — plus,
    optionally, mirrored to the task's owner (`mirror_fn`; the
    RAY_TPU_LOG_TO_DRIVER path — None when unarmed, so the mirror
    branch costs one `is None` check).

    The capture meters its own CPU (`cpu_seconds`, thread_time deltas
    around the structured-emit work only) so the armed-overhead
    contract (<1% of a busy window) is a measured number, the stack
    sampler's pattern. A thread-local reentry guard makes an emit path
    that itself prints (a failing mirror send, a logging hook) pass
    straight through instead of recursing."""

    def __init__(self, inner, source: str, sink: LogSink,
                 ident: dict, mirror_fn=None):
        super().__init__()
        self.inner = inner
        self.source = source  # "stdout" | "stderr"
        self.sink = sink
        self.ident = dict(ident)
        self.mirror_fn = mirror_fn
        self.cpu_seconds = 0.0  # guarded_by(_cpu_lock)
        self._cpu_lock = threading.Lock()
        # per-thread reentry flag + line buffer: the worker's exec
        # threads all print through this ONE capture, and line assembly
        # in a shared buffer would interleave concurrent tasks' partial
        # lines (losing some, misattributing the merged rest)
        self._tls = threading.local()

    def writable(self) -> bool:
        return True

    def write(self, s) -> int:
        try:
            n = self.inner.write(s)
        except Exception:  # noqa: BLE001
            n = len(s)
        tls = self._tls
        if getattr(tls, "on", False):
            return n
        tls.on = True
        c0 = time.thread_time()
        try:
            buf = getattr(tls, "buf", "") + \
                (s if isinstance(s, str) else str(s))
            while "\n" in buf:
                line, buf = buf.split("\n", 1)
                if not line.strip():
                    continue
                self._emit(line)
            if len(buf) > MAX_MSG_BYTES:  # unterminated flood
                self._emit(buf)
                buf = ""
            tls.buf = buf
        except Exception:  # noqa: BLE001
            pass  # the real stream already has the text
        finally:
            dt = time.thread_time() - c0
            # a bare += from N exec threads loses deltas, and this
            # number gates the <1% armed-overhead contract
            with self._cpu_lock:
                self.cpu_seconds += dt
            tls.on = False
        return n

    def _emit(self, line: str) -> None:
        attribution = _runtime_attribution()
        rec = {
            "ts": epoch_us() / 1e6,
            "level": "warning" if self.source == "stderr" else "info",
            "logger": "",
            "msg": line[:MAX_MSG_BYTES],
            "source": self.source,
            **self.ident,
            **attribution,
        }
        self.sink.write(rec)
        if self.mirror_fn is not None:
            self.mirror_fn(line[:MAX_MSG_BYTES], self.source)

    def flush(self) -> None:
        try:
            self.inner.flush()
        except Exception:  # noqa: BLE001
            pass

    def fileno(self) -> int:
        return self.inner.fileno()

    @property
    def encoding(self):  # subprocess/print interop
        return getattr(self.inner, "encoding", "utf-8")

    def isatty(self) -> bool:
        try:
            return self.inner.isatty()
        except Exception:  # noqa: BLE001
            return False


# ---------------------------------------------------------- installation

_state_lock = threading.Lock()
_installed: dict | None = None  # {"sink", "handler", "ident"}


def install_process_logging(role: str, log_dir: str | None = None,
                            node_id: str = "", proc: str = "",
                            level: str | None = None
                            ) -> StructuredLogHandler:
    """Install the structured handler on this process's root logger
    (idempotent — the first install wins, later calls return it).
    `log_dir` None keeps a counting-only sink (records metered, no
    file). Called by the processes the runtime owns — worker_main,
    `python -m ray_tpu_torch.core.nodelet` — never implicitly from
    library imports, so embedding applications keep
    their own logging untouched."""
    global _installed
    with _state_lock:
        if _installed is not None:
            return _installed["handler"]
        path = None
        if log_dir:
            path = os.path.join(log_dir, f"{role}-{proc or os.getpid()}"
                                         f".jsonl")
        sink = LogSink(path)
        handler = StructuredLogHandler(sink, node=node_id, proc=proc,
                                       role=role)
        root = logging.getLogger()
        root.addHandler(handler)
        lvl = (level or os.environ.get("RAY_TPU_LOG_LEVEL", "info"))
        root.setLevel(min(root.level or 100, level_no(lvl)))
        _installed = {"sink": sink, "handler": handler,
                      "ident": dict(handler.ident)}
        return handler


def install_stream_capture(mirror_fn=None
                           ) -> tuple[StdStreamCapture, StdStreamCapture]:
    """Wrap sys.stdout/sys.stderr with attributing captures feeding the
    installed sink (requires `install_process_logging` first). Returns
    the two captures (tests read their counters)."""
    with _state_lock:
        if _installed is None:
            raise RuntimeError("install_process_logging first")
        sink, ident = _installed["sink"], _installed["ident"]
        if isinstance(sys.stdout, StdStreamCapture):
            return sys.stdout, sys.stderr  # already wrapped
        out = StdStreamCapture(sys.stdout, "stdout", sink, ident,
                               mirror_fn)
        err = StdStreamCapture(sys.stderr, "stderr", sink, ident,
                               mirror_fn)
        sys.stdout, sys.stderr = out, err
        return out, err


def installed_sink() -> LogSink | None:
    with _state_lock:
        return _installed["sink"] if _installed else None


# ------------------------------------------------------------ query path

def _iter_jsonl_files(log_dir: str) -> list[str]:
    """Structured log files in a log dir, rotated halves first (so a
    per-file sequential read yields time order within each stem)."""
    try:
        names = os.listdir(log_dir)
    except OSError:
        return []
    out = []
    for name in sorted(names):
        if name.endswith(".jsonl.1"):
            out.append(name)
    for name in sorted(names):
        if name.endswith(".jsonl"):
            out.append(name)
    return out


def _record_matches(rec: dict, level_min: int, grep, since, until,
                    trace_id, task, proc) -> bool:
    if level_min > 10 and level_no(rec.get("level", "info")) < level_min:
        return False
    ts = rec.get("ts", 0.0)
    if since is not None and ts < since:
        return False
    if until is not None and ts > until:
        return False
    if trace_id is not None and rec.get("trace_id") != trace_id:
        return False
    if task is not None and rec.get("task") != task:
        return False
    if proc is not None and rec.get("proc") != proc:
        return False
    if grep is not None and not (
            grep.search(rec.get("msg", "")) or
            grep.search(rec.get("logger", ""))):
        return False
    return True


def query_log_dir(log_dir: str, *, level: str | None = None,
                  grep: str | None = None, since: float | None = None,
                  until: float | None = None,
                  trace_id: str | None = None, task: str | None = None,
                  proc: str | None = None, limit: int = 1000,
                  offsets: dict | None = None,
                  scan_bytes: int = 1 << 20,
                  node: str | None = None) -> dict:
    """Filtered scan over a node's structured JSONL logs — the body of
    the nodelet's `log_query` RPC, importable directly for local use.

    Bounded by construction: per-file reads cover at most `scan_bytes`
    from the tail when no offset is known (a fresh query is a tail, not
    a full-history scan), the reply keeps the LAST `limit` records by
    ts (cap 5000), and `offsets` (``{filename: [inode, byte]}`` from a
    previous reply) turns repeated calls into incremental follows —
    only new bytes are read. Cursors are inode-tagged so a rotation
    under the follower is detected by IDENTITY, not size: the current
    file's cursor carries over to the `.1` half its inode moved to and
    the follow resumes without duplicates or silent skips, however
    much the recreated file has grown meanwhile (only a DOUBLE
    rotation inside one poll gap loses the rotated-out tail). `node`
    filters records to one origin node — the nodelet passes its own id
    so shared-log-dir test clusters never double-report."""
    import re as _re

    limit = max(1, min(int(limit), 5000))
    level_min = level_no(level) if level else 0
    grep_re = _re.compile(grep) if grep else None
    offsets = dict(offsets or {})

    def _cursor(entry):
        """(inode|None, byte) from a cursor entry ([ino, off] replies;
        bare ints accepted for pre-inode callers)."""
        if isinstance(entry, (list, tuple)) and len(entry) == 2:
            return int(entry[0]), int(entry[1])
        return None, int(entry)

    # rotation under a follower: the current file's cursor no longer
    # matches the inode it was taken against (or sits past the size,
    # for inode-less legacy cursors) — the bytes it had read were
    # os.replace'd into the `.1` half, so the cursor carries over
    # there and the follow resumes exactly where it left off (the
    # `.1` cursor it overwrites pointed into content that no longer
    # exists)
    for name in [n for n in offsets if not n.endswith(".1")]:
        ino, off = _cursor(offsets[name])
        try:
            st = os.stat(os.path.join(log_dir, name))
            rotated = off > st.st_size or \
                (ino is not None and ino != st.st_ino)
        except OSError:
            # rotated away and not yet recreated (a poll can land in
            # the replace→next-write gap)
            rotated = True
        if rotated:
            carried = [ino, off] if ino is not None else off
            cur1 = offsets.get(name + ".1")
            if cur1 is not None:
                ino1, off1 = _cursor(cur1)
                # keep the FRESHER cursor when both describe the same
                # inode: a rotation-gap poll may have already carried
                # and advanced the `.1` cursor while the caller's
                # stale current-file cursor survived a merge
                if off1 >= off and (ino is None or ino1 is None
                                    or ino1 == ino):
                    carried = cur1
            offsets[name + ".1"] = carried
            offsets[name] = 0
    out_offsets: dict[str, list] = {}
    records: list[dict] = []
    truncated = False
    for name in _iter_jsonl_files(log_dir):
        path = os.path.join(log_dir, name)
        try:
            with open(path, "rb") as f:
                st = os.fstat(f.fileno())
                size = st.st_size
                entry = offsets.get(name)
                if entry is None:
                    start = max(0, size - scan_bytes)
                else:
                    ino, start = _cursor(entry)
                    if start > size or \
                            (ino is not None and ino != st.st_ino):
                        # cursor taken against a file this no longer
                        # is (double rotation inside one poll gap):
                        # everything here is unseen — read it all
                        start = 0
                f.seek(start)
                if start > 0 and entry is None:
                    f.readline()  # discard the partial first line
                data = f.read(size - f.tell() if size > f.tell() else 0)
                out_offsets[name] = [st.st_ino, f.tell()]
        except OSError:
            continue
        for raw in data.splitlines():
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if node is not None and rec.get("node") not in (node, None):
                continue
            if _record_matches(rec, level_min, grep_re, since, until,
                               trace_id, task, proc):
                rec.setdefault("file", name)
                records.append(rec)
                if len(records) > 4 * limit:
                    # keep the scan's working set bounded too
                    records.sort(key=lambda r: r.get("ts", 0.0))
                    del records[:len(records) - 2 * limit]
                    truncated = True
    records.sort(key=lambda r: r.get("ts", 0.0))
    if len(records) > limit:
        truncated = True
        records = records[-limit:]
    return {"records": records, "offsets": out_offsets,
            "truncated": truncated}


def format_record(rec: dict) -> str:
    """One human line per record — the `ray_tpu_torch.scripts.cli logs`
    CLI shape."""
    t = time.strftime("%H:%M:%S", time.localtime(rec.get("ts", 0.0)))
    origin = f"{rec.get('proc') or rec.get('role') or '?'}" \
             f"@{(rec.get('node') or '?')[:12]}"
    task = rec.get("task_name") or (rec.get("task") or "")[:12]
    task_part = f" [{task}]" if task else ""
    src = rec.get("source", "log")
    name = rec.get("logger") or src
    return (f"{t} {rec.get('level', 'info'):<8} ({origin})"
            f"{task_part} {name}: {rec.get('msg', '')}")
