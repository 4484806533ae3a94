"""Runtime selection + the in-process LocalRuntime: the port's copy of
``ray_tpu/core/runtime.py``.

`make_runtime` picks the backend for `ray_tpu_torch.init()`:
- `local_mode=True` → `LocalRuntime`: threads in this process, full API
  semantics (the semantic reference for the distributed runtime; cf.
  reference local mode). Objects stay in this process: `get` returns
  the very object a task returned or `put` stored, so a CUDA tensor
  passes by reference, its storage shared.
- otherwise it raises: the cluster runtime (controller, nodelets and
  worker processes) is not ported yet, and the port does not fall back
  to local mode.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
import traceback
from typing import Any, Callable

from ray_tpu_torch.core import exceptions as exc
from ray_tpu_torch.core.api import ActorHandle, ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch.core.options import ActorOptions, TaskOptions
from ray_tpu_torch.core.runtime_context import RuntimeContext
from ray_tpu_torch.utils.events import TaskEventLog, child_trace


def make_runtime(address=None, local_mode=False, **kwargs):
    if local_mode:
        return LocalRuntime(**kwargs)
    raise NotImplementedError(
        "ray_tpu_torch.init() without local_mode=True needs the cluster "
        "runtime, which is not ported yet"
        + (f" (address={address!r})" if address else "")
        + "; call init(local_mode=True)")


# ---------------------------------------------------------------- slots


class _Slot:
    __slots__ = ("event", "value", "error", "cancelled")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: BaseException | None = None
        self.cancelled = False

    def set_value(self, v):
        self.value = v
        self.event.set()

    def set_error(self, e: BaseException):
        self.error = e
        self.event.set()


@dataclasses.dataclass
class _LocalActor:
    actor_id: ActorID
    cls: type
    args: tuple
    kwargs: dict
    opts: ActorOptions
    inbox: _queue.Queue = dataclasses.field(default_factory=_queue.Queue)
    instance: Any = None
    dead: bool = False
    death_cause: str = ""
    restarts_left: int = 0
    threads: list = dataclasses.field(default_factory=list)
    init_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    init_done: threading.Event = dataclasses.field(default_factory=threading.Event)


class _LocalStream:
    """Local-mode order book for one streaming-generator task (same
    semantics as the cluster _StreamState, minus the wire)."""

    __slots__ = ("cond", "oids", "end", "error", "closed", "consumed")

    def __init__(self):
        self.cond = threading.Condition()
        self.oids: list[ObjectID] = []
        self.end = False
        self.error: BaseException | None = None
        self.closed = False
        self.consumed = 0


class _Context(threading.local):
    def __init__(self):
        self.actor_id: ActorID | None = None
        self.task_id: TaskID | None = None
        # active trace context — local mode threads {trace_id, span_id,
        # parent_id} through submits exactly like the cluster runtime
        self.trace: dict | None = None


class LocalRuntime:
    """Whole-cluster semantics in one process. Tasks run on daemon
    threads; actors get dedicated ordered-execution threads."""

    def __init__(self, num_cpus=None, num_gpus=None, resources=None,
                 namespace=None, labels=None, **_):
        self.job_id = JobID.random()
        self.node_id = NodeID.random()
        self.worker_id = WorkerID.random()
        self.namespace = namespace or "default"
        self._objects: dict[ObjectID, _Slot] = {}
        self._refcounts: dict[ObjectID, int] = {}
        # RLock: _decref runs from ObjectRef.__del__ at ARBITRARY gc
        # points, including while this same thread holds the lock (e.g.
        # an allocation inside _slot's critical section triggers gc) — a
        # plain Lock self-deadlocks there. Reentrant dict pops of OTHER
        # oids are safe against every critical section below.
        self._objects_lock = threading.RLock()
        self._actors: dict[ActorID, _LocalActor] = {}
        self._named: dict[tuple[str, str], ActorID] = {}
        self._actors_lock = threading.Lock()
        self._ctx = _Context()
        self._events = TaskEventLog()
        self._resources = dict(resources or {})
        self._resources.setdefault("CPU", num_cpus if num_cpus is not None else 8)
        if num_gpus:
            self._resources["GPU"] = num_gpus
        # RLock: stream_close runs from ObjectRefGenerator.__del__ at
        # arbitrary gc points (same reasoning as _objects_lock)
        self._streams: dict[bytes, _LocalStream] = {}
        self._streams_lock = threading.RLock()
        self._shutdown = False

    # ------------------------------------------------------------ objects

    def _slot(self, oid: ObjectID) -> _Slot:
        with self._objects_lock:
            s = self._objects.get(oid)
            if s is not None:
                return s
        fresh = _Slot()  # allocate OUTSIDE the lock: gc can run here
        with self._objects_lock:
            return self._objects.setdefault(oid, fresh)

    # Local reference counting driven by ObjectRef lifetime (reference:
    # ReferenceCounter, core_worker/reference_count.h:66). When the last
    # ObjectRef to an oid is GC'd, the stored value is dropped.
    def _incref(self, oid: ObjectID, owner=None):
        with self._objects_lock:
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1

    def _decref(self, oid: ObjectID, owner=None):
        with self._objects_lock:
            c = self._refcounts.get(oid, 0) - 1
            if c <= 0:
                self._refcounts.pop(oid, None)
                self._objects.pop(oid, None)
            else:
                self._refcounts[oid] = c

    def put(self, value) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed")
        oid = ObjectID.random()
        self._slot(oid).set_value(value)
        return ObjectRef(oid)

    def deferred(self):
        """A promise: (ref, fulfill, reject). The ref behaves like any
        owned object — `get` blocks until one of the callbacks runs.
        Serve handles use this to front a retried submit with ONE ref
        whose result may come from a different replica than the first
        attempt (failover relays)."""
        oid = ObjectID.random()
        s = self._slot(oid)
        return ObjectRef(oid), s.set_value, s.set_error

    def get(self, refs: list[ObjectRef], timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in refs:
            s = self._slot(r.id)
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not s.event.wait(remaining):
                raise exc.GetTimeoutError(f"get() timed out waiting for {r}")
            if s.error is not None:
                raise s.error
            out.append(s.value)
        return out

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready, not_ready = [], list(refs)
        while True:
            still = []
            for r in not_ready:
                if self._slot(r.id).event.is_set():
                    ready.append(r)
                else:
                    still.append(r)
            not_ready = still
            if len(ready) >= num_returns or not not_ready:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.001)
        return ready, not_ready

    def as_future(self, ref: ObjectRef):
        import concurrent.futures as cf

        fut = cf.Future()
        s = self._slot(ref.id)

        def waiter():
            s.event.wait()
            if s.error is not None:
                fut.set_exception(s.error)
            else:
                fut.set_result(s.value)

        threading.Thread(target=waiter, daemon=True).start()
        return fut

    def _resolve_args(self, args, kwargs):
        def resolve(v):
            if isinstance(v, ObjectRef):
                return self.get([v])[0]
            return v

        return tuple(resolve(a) for a in args), {k: resolve(v) for k, v in kwargs.items()}

    # ------------------------------------------------------------ streams

    def _run_stream_local(self, stream: _LocalStream, gen,
                          backpressure: int):
        try:
            for value in gen:
                with stream.cond:
                    if stream.closed:
                        break
                    oid = ObjectID.random()
                    self._slot(oid).set_value(value)
                    stream.oids.append(oid)
                    stream.cond.notify_all()
                    while (backpressure and not stream.closed and
                           len(stream.oids) - stream.consumed >=
                           backpressure):
                        stream.cond.wait(0.5)
        except Exception as e:  # noqa: BLE001
            with stream.cond:
                stream.error = exc.TaskError.from_exception(e, "stream")
                stream.cond.notify_all()
            return
        finally:
            if hasattr(gen, "close"):
                try:
                    gen.close()
                except Exception:  # noqa: BLE001
                    pass
        with stream.cond:
            stream.end = True
            stream.cond.notify_all()

    def stream_next(self, task_id: bytes, owner: str, index: int,
                    timeout: float | None = None):
        with self._streams_lock:
            stream = self._streams.get(task_id)
        if stream is None:
            raise StopIteration
        deadline = None if timeout is None else time.monotonic() + timeout
        with stream.cond:
            while True:
                if index < len(stream.oids):
                    stream.consumed = max(stream.consumed, index + 1)
                    stream.cond.notify_all()
                    return ObjectRef(stream.oids[index])
                if stream.error is not None:
                    raise stream.error
                if stream.end:
                    break
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    raise exc.GetTimeoutError("stream_next timed out")
                stream.cond.wait(min(rem, 1.0) if rem is not None else 1.0)
        with self._streams_lock:
            self._streams.pop(task_id, None)
        raise StopIteration

    def stream_close(self, task_id: bytes, owner: str):
        with self._streams_lock:
            stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        with stream.cond:
            stream.closed = True
            drop = stream.oids[stream.consumed:]
            stream.cond.notify_all()
        with self._objects_lock:
            for oid in drop:
                if self._refcounts.get(oid, 0) <= 0:
                    self._objects.pop(oid, None)

    # ------------------------------------------------------------ tasks

    def submit_task(self, fn: Callable, args, kwargs, opts: TaskOptions):
        streaming = opts.num_returns in ("streaming", "dynamic")
        # child context derived on the SUBMITTING thread (the parent span
        # is whatever is active here), adopted by the execution thread
        trace = child_trace(self._ctx.trace)
        if streaming:
            task_id = TaskID.random()
            stream = _LocalStream()
            with self._streams_lock:
                self._streams[task_id.binary()] = stream
            bp = int(opts.generator_backpressure_num_objects or 0)

            def run_stream():
                self._ctx.task_id = task_id
                self._ctx.trace = trace
                try:
                    a, kw = self._resolve_args(args, kwargs)
                    gen = fn(*a, **kw)
                except Exception as e:  # noqa: BLE001
                    with stream.cond:
                        stream.error = exc.TaskError.from_exception(
                            e, opts.name or fn.__name__)
                        stream.cond.notify_all()
                    return
                self._run_stream_local(stream, gen, bp)

            threading.Thread(target=run_stream, daemon=True,
                             name=f"stream-{fn.__name__}").start()
            return ObjectRefGenerator(task_id.binary(), "local")
        n = opts.num_returns
        oids = [ObjectID.random() for _ in range(n)]
        slots = [self._slot(o) for o in oids]
        task_id = TaskID.random()
        name = opts.name or fn.__name__

        def run():
            self._ctx.task_id = task_id
            self._ctx.trace = trace
            tries = opts.max_retries + 1 if opts.retry_exceptions else 1
            with self._events.span(name, "task", trace=trace):
                for attempt in range(max(1, tries)):
                    if any(s.cancelled for s in slots):
                        for s in slots:
                            s.set_error(exc.TaskCancelledError(name))
                        return
                    try:
                        a, kw = self._resolve_args(args, kwargs)
                        result = fn(*a, **kw)
                        if n == 0:
                            return
                        if n == 1:
                            slots[0].set_value(result)
                        else:
                            vals = list(result)
                            if len(vals) != n:
                                raise ValueError(
                                    f"task {name} returned {len(vals)} values, "
                                    f"expected num_returns={n}"
                                )
                            for s, v in zip(slots, vals):
                                s.set_value(v)
                        return
                    except Exception as e:  # noqa: BLE001
                        if attempt + 1 < tries and _should_retry(e, opts.retry_exceptions):
                            continue
                        err = exc.TaskError.from_exception(e, name)
                        for s in slots:
                            s.set_error(err)
                        return

        threading.Thread(target=run, daemon=True, name=f"task-{name}").start()
        refs = [ObjectRef(o) for o in oids]
        if n == 0:
            return []
        return refs[0] if n == 1 else refs

    def cancel(self, ref: ObjectRef, force=False, recursive=True):
        self._slot(ref.id).cancelled = True

    # ------------------------------------------------------------ actors

    def create_actor(self, cls, args, kwargs, opts: ActorOptions) -> ActorHandle:
        with self._actors_lock:
            # check + register must be atomic, or concurrent
            # get_if_exists creators race into duplicate actors
            if opts.name:
                key = (opts.namespace or self.namespace, opts.name)
                if key in self._named:
                    if opts.get_if_exists:
                        return self._handle(self._actors[self._named[key]])
                    raise ValueError(f"actor name {opts.name!r} already taken")
            actor = _LocalActor(
                actor_id=ActorID.random(),
                cls=cls,
                args=args,
                kwargs=kwargs,
                opts=opts,
                restarts_left=opts.max_restarts,
            )
            self._actors[actor.actor_id] = actor
            if opts.name:
                self._named[(opts.namespace or self.namespace, opts.name)] = actor.actor_id
        for i in range(max(1, opts.max_concurrency)):
            t = threading.Thread(
                target=self._actor_loop, args=(actor,), daemon=True,
                name=f"actor-{cls.__name__}-{i}",
            )
            actor.threads.append(t)
            t.start()
        return self._handle(actor)

    def _handle(self, actor: _LocalActor) -> ActorHandle:
        meta = {}
        for mname in dir(actor.cls):
            m = getattr(actor.cls, mname, None)
            if callable(m) and hasattr(m, "__ray_tpu_method_options__"):
                meta[mname] = m.__ray_tpu_method_options__
        return ActorHandle(actor.actor_id, meta)

    def _actor_loop(self, actor: _LocalActor):
        self._ctx.actor_id = actor.actor_id
        with actor.init_lock:
            if actor.instance is None and not actor.dead and not actor.init_done.is_set():
                try:
                    a, kw = self._resolve_args(actor.args, actor.kwargs)
                    actor.instance = actor.cls(*a, **kw)
                except Exception as e:  # noqa: BLE001
                    actor.dead = True
                    actor.death_cause = f"__init__ failed: {e}\n{traceback.format_exc()}"
                finally:
                    actor.init_done.set()
        actor.init_done.wait()
        while not actor.dead and not self._shutdown:
            try:
                item = actor.inbox.get(timeout=0.1)
            except _queue.Empty:
                continue
            if item is None:
                break
            mname, args, kwargs, slots, stream_meta, trace = item
            self._ctx.trace = trace
            with self._events.span(f"{actor.cls.__name__}.{mname}",
                                   "actor_task", trace=trace):
                try:
                    a, kw = self._resolve_args(args, kwargs)
                    fn = getattr(actor.instance, mname)
                    if stream_meta is not None:
                        gen = fn(*a, **kw)
                        self._run_stream_local(stream_meta["stream"], gen,
                                               stream_meta["bp"])
                        continue
                    result = fn(*a, **kw)
                    if len(slots) == 1:
                        slots[0].set_value(result)
                    else:
                        for s, v in zip(slots, list(result)):
                            s.set_value(v)
                except Exception as e:  # noqa: BLE001
                    err = exc.TaskError.from_exception(e, f"{actor.cls.__name__}.{mname}")
                    if stream_meta is not None:
                        st = stream_meta["stream"]
                        with st.cond:
                            st.error = err
                            st.cond.notify_all()
                        continue
                    for s in slots:
                        s.set_error(err)
        # Error-drain anything still queued so callers never hang on a
        # dead actor (one loop thread may exit while others drain too —
        # set_error is idempotent enough: first writer wins the event).
        self._drain_actor_inbox(actor)

    def _drain_actor_inbox(self, actor: _LocalActor):
        cause = actor.death_cause or "actor exited"
        try:
            while True:
                item = actor.inbox.get_nowait()
                if item:
                    self._fail_actor_item(item, cause)
        except _queue.Empty:
            pass

    @staticmethod
    def _fail_actor_item(item, cause: str):
        err = exc.ActorDiedError(cause)
        if len(item) > 4 and item[4] is not None:
            st = item[4]["stream"]
            with st.cond:
                st.error = err
                st.cond.notify_all()
            return
        for s in item[3]:
            s.set_error(err)

    def submit_actor_task(self, actor_id: ActorID, mname: str, args, kwargs, mopts: dict):
        with self._actors_lock:
            actor = self._actors.get(actor_id)
        if actor is None:
            raise exc.ActorDiedError(f"no such actor {actor_id}")
        nr = mopts.get("num_returns", 1)
        trace = child_trace(self._ctx.trace)
        if nr in ("streaming", "dynamic"):
            task_id = TaskID.random()
            stream = _LocalStream()
            with self._streams_lock:
                self._streams[task_id.binary()] = stream
            meta = {"stream": stream, "bp": int(
                mopts.get("generator_backpressure_num_objects") or 0)}
            item = (mname, args, kwargs, [], meta, trace)
            if actor.dead:
                self._fail_actor_item(item, actor.death_cause
                                      or "actor is dead")
            else:
                actor.inbox.put(item)
                if actor.dead:
                    self._drain_actor_inbox(actor)
            return ObjectRefGenerator(task_id.binary(), "local")
        n = int(nr)
        oids = [ObjectID.random() for _ in range(n)]
        slots = [self._slot(o) for o in oids]
        if actor.dead:
            for s in slots:
                s.set_error(exc.ActorDiedError(actor.death_cause or "actor is dead"))
        else:
            actor.inbox.put((mname, args, kwargs, slots, None, trace))
            if actor.dead:
                # lost the race with actor death: loop threads may have
                # already drained and exited — drain again ourselves.
                self._drain_actor_inbox(actor)
        refs = [ObjectRef(o) for o in oids]
        return refs[0] if n == 1 else refs

    def kill_actor(self, actor_id: ActorID, no_restart=True):
        with self._actors_lock:
            actor = self._actors.get(actor_id)
        if actor is None:
            return
        actor.dead = True
        actor.death_cause = "killed via ray_tpu_torch.kill()"
        # drain pending calls with ActorDiedError
        try:
            while True:
                item = actor.inbox.get_nowait()
                if item:
                    for s in item[3]:
                        s.set_error(exc.ActorDiedError(actor.death_cause))
        except _queue.Empty:
            pass

    def get_named_actor(self, name: str, namespace=None) -> ActorHandle:
        key = (namespace or self.namespace, name)
        with self._actors_lock:
            aid = self._named.get(key)
            if aid is None or self._actors[aid].dead:
                raise ValueError(f"no live actor named {name!r}")
            return self._handle(self._actors[aid])

    # ------------------------------------------------------------ cluster

    def nodes(self):
        return [
            {
                "NodeID": self.node_id.hex(),
                "Alive": True,
                "Resources": dict(self._resources),
                "Labels": {},
                "NodeManagerAddress": "127.0.0.1",
            }
        ]

    def cluster_resources(self):
        return dict(self._resources)

    def available_resources(self):
        return dict(self._resources)

    def runtime_context(self):
        return RuntimeContext(
            job_id=self.job_id,
            node_id=self.node_id,
            worker_id=self.worker_id,
            actor_id=self._ctx.actor_id,
            task_id=self._ctx.task_id,
            namespace=self.namespace,
        )

    def timeline(self, filename=None):
        return self._events.chrome_trace(filename)

    def context_info(self):
        return {"node_id": self.node_id.hex(), "local_mode": True}

    def shutdown(self):
        self._shutdown = True
        with self._actors_lock:
            for a in self._actors.values():
                a.dead = True
                a.inbox.put(None)


def _should_retry(e: BaseException, retry_exceptions) -> bool:
    if retry_exceptions is True:
        return True
    if isinstance(retry_exceptions, (list, tuple)):
        return isinstance(e, tuple(retry_exceptions))
    return False
