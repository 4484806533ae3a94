"""Worker process — task execution loop + actor hosting.

Reference parity: default_worker.py + CoreWorker::RunTaskExecutionLoop
(src/ray/core_worker/core_worker.h:216) and the task receiver /
actor scheduling queues (core_worker/transport/task_receiver.h,
actor_scheduling_queue.h). The nodelet spawns this with env-var wiring;
tasks arrive as direct RPC pushes (execute_task for leased normal tasks,
actor_call straight from callers); results go DIRECTLY to the owner.

The port's copy of ``ray_tpu/core/worker_main.py``: functions and actor
classes arrive pickled by value (serialization.dumps_fn), not through
cloudpickle. The worker installs the structured log plane: its logging
calls land in the node's JSONL log dir with task and trace attribution,
and its prints are captured (and mirrored to the submitting driver when
RAY_TPU_LOG_TO_DRIVER is set). A compiled graph's stage (dag_start)
runs as a resident loop over the port's shared-memory channels
(experimental/channel.py). The
worker exits when its nodelet's process is gone: its parent changes, or
three pings in a row go unanswered.
"""

from __future__ import annotations

import os
import queue as _queue
import sys
import tempfile
import threading
import time
import traceback

from ray_tpu_torch.core import exceptions as exc
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.api import ObjectRef, _set_runtime
from ray_tpu_torch.core.cluster_runtime import ClusterRuntime, _submit_coalesced
from ray_tpu_torch.core.rpc import Batcher
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID
from ray_tpu_torch.core.object_store import (
    ObjectStoreFullError,
    open_store,
)
from ray_tpu_torch.core.specs import INLINE_THRESHOLD, ActorSpec, RefArg, TaskSpec


class WorkerRuntime(ClusterRuntime):
    """ClusterRuntime + execution-side handlers."""

    def __init__(self):
        head = os.environ["RAY_TPU_HEAD_ADDR"]
        nodelet = os.environ["RAY_TPU_NODELET_ADDR"]
        super().__init__(mode="worker", head=head, nodelet=nodelet)
        self.node_id = NodeID.from_hex(os.environ["RAY_TPU_NODE_ID"])
        self.worker_id_bytes = bytes.fromhex(os.environ["RAY_TPU_WORKER_ID"])
        self.store = open_store(name=os.environ["RAY_TPU_STORE_NAME"],
                                create=False)
        self._actor_instance = None
        self._actor_spec: ActorSpec | None = None
        self._actor_groups: dict[str, _queue.Queue] = {}
        self._async_loop = None
        self._async_loop_lock = threading.Lock()
        # at-least-once dedup: callers retry actor_call on slow replies;
        # executing the same method call twice corrupts actor state
        self._seen_calls: set[bytes] = set()
        self._seen_calls_order: list[bytes] = []
        self._seen_lock = threading.Lock()
        # leased-task inbox: owners with a worker lease push tasks here
        # DIRECTLY (reference: lease reuse + OnWorkerIdle pipelined pushes,
        # core_worker/transport/normal_task_submitter.cc:137). One serial
        # executor thread — a lease is one task-slot's worth of CPU.
        self._task_inbox: _queue.Queue = _queue.Queue()
        threading.Thread(target=self._task_exec_loop, daemon=True,
                         name="leased-task-exec").start()
        self._event_buf: list = []
        self._event_buf_lock = threading.Lock()
        # consecutive flush failures (heuristic poison cap; updated from
        # the flush loop and threshold flushes — races only skew the cap)
        self._flush_failures = 0
        threading.Thread(target=self._event_flush_loop, daemon=True,
                         name="task-event-flush").start()
        # the lease this worker currently serves (set by the nodelet at
        # grant time, cleared at return/expiry); guards direct pushes
        self._current_lease: bytes | None = None
        # active streaming-generator producers: task_id -> cancel event
        # (reference: generator execution + backpressure in _raylet.pyx)
        self._active_streams: dict[bytes, threading.Event] = {}
        self._active_streams_lock = threading.Lock()
        self.server.register("stream_cancel", self._h_stream_cancel,
                             oneway=True)
        self.server.register("execute_task", self._h_execute_task, oneway=True)
        self.server.register("execute_leased", self._h_execute_leased)
        self.server.register("set_lease", self._h_set_lease)
        self.server.register("become_actor", self._h_become_actor, oneway=True)
        self.server.register("actor_call", self._h_actor_call)
        self.server.register("actor_calls", self._h_actor_calls)
        self.server.register("dag_start", self._h_dag_start)
        self.server.register("dag_stop", self._h_dag_stop)
        self.server.register("exit_worker", self._h_exit, oneway=True)
        self._dag_loops: dict[str, threading.Event] = {}
        # return-path coalescer: per-task task_done oneways to the same
        # owner pack into one task_done_batch frame. Flush is
        # idle-triggered (an exec thread whose inbox drained flushes
        # NOW, so a lone sync task pays zero window latency) with the
        # batcher's size cap and window as the burst/straggler bounds.
        self._done_batcher = Batcher("task-done", self._flush_task_done,
                                     observe_sizes=True)

    # ------------------------------------------------------------ args

    def _decode_args(self, args, kwargs):
        def dec(v):
            if isinstance(v, RefArg):
                ref = ObjectRef(ObjectID(v.oid), owner=v.owner)
                return self._get_one(ref, None)
            return v

        return tuple(dec(a) for a in args), {k: dec(v) for k, v in kwargs.items()}

    # ------------------------------------------------------------ results

    def _create_making_room(self, owner: str, oid: bytes, size: int):
        """`store.create`; when the store is full, ask the object's owner
        to spill its primaries in this node's store and retry once. Raises
        ObjectStoreFullError when there is still no room (the caller then
        ships the value inline)."""
        try:
            return self.store.create(oid, size)
        except ObjectStoreFullError:
            try:
                freed = self.client.call(
                    owner, "spill_request",
                    {"bytes": size, "store_name": self.store.name},
                    timeout=60).get("freed", 0)
            except Exception:  # noqa: BLE001
                freed = 0
            if not freed:
                raise
        return self.store.create(oid, size)

    def _ship_results(self, owner: str, task_id: bytes, oids: list[bytes],
                      values: list):
        frames = []
        locations = []
        for b, v in zip(oids, values):
            head_payload, views, total = ser.serialize(v)
            if total <= INLINE_THRESHOLD:
                buf = bytearray(total)
                ser.write_into(memoryview(buf), head_payload, views)
                frames.append(bytes(buf))
                locations.append(None)
            else:
                try:
                    mv = self._create_making_room(owner, b, total)
                    ser.write_into(mv, head_payload, views)
                    del mv
                    self.store.seal(b)
                    frames.append(b"")
                    locations.append({"address": self.nodelet_address,
                                      "store_name": self.store.name,
                                      "size": total})
                except KeyError:
                    frames.append(b"")
                    locations.append({"address": self.nodelet_address,
                                      "store_name": self.store.name,
                                      "size": total})
                except Exception:
                    buf = bytearray(total)
                    ser.write_into(memoryview(buf), head_payload, views)
                    frames.append(bytes(buf))
                    locations.append(None)
        self._done_batcher.append(owner, ({
            "task_id": task_id, "oids": oids, "locations": locations,
        }, frames))

    def _ship_error(self, owner: str, task_id: bytes, oids: list[bytes],
                    error: BaseException, retryable=False):
        try:
            blob = ser.dumps_msg(error)
        except Exception:
            blob = ser.dumps_msg(exc.TaskError(RuntimeError(repr(error))))
        try:
            self._done_batcher.append(owner, ({
                "task_id": task_id, "oids": oids, "error": blob,
                "retryable": retryable,
            }, []))
        except Exception:
            pass

    def _flush_task_done(self, owner: str, entries: list):
        """Batcher flush hook: one frame per owner. A singleton stays a
        plain task_done; N completions ride one task_done_batch with
        their result frames concatenated in entry order."""
        try:
            if len(entries) == 1:
                m, fr = entries[0]
                self.client.send_oneway(owner, "task_done", m, frames=fr)
                return
            self.client.send_oneway(
                owner, "task_done_batch",
                {"entries": [m for m, _ in entries],
                 "counts": [len(fr) for _, fr in entries]},
                frames=[f for _, fr in entries for f in fr])
            _submit_coalesced("task_done", len(entries))
        except Exception:  # noqa: BLE001
            pass  # oneways are best-effort by contract

    # ------------------------------------------------------------ streaming

    def _h_stream_cancel(self, msg, frames):
        """Owner dropped the generator handle: stop producing."""
        with self._active_streams_lock:
            ev = self._active_streams.get(msg["task_id"])
        if ev is not None:
            ev.set()

    @staticmethod
    def stream_item_oid(task_id: bytes, index: int) -> bytes:
        """Deterministic item oid: a retried producer regenerates the SAME
        ids, so replayed stream_items dedup/heal at the owner instead of
        forking the stream (reference: dynamic return ids are deterministic
        in (task_id, index), src/ray/common/id.h ObjectID::FromIndex)."""
        import hashlib

        return hashlib.sha1(
            b"stream" + task_id + index.to_bytes(8, "little")).digest()[:16]

    def _run_stream(self, owner: str, task_id: bytes, gen,
                    backpressure: int) -> int:
        """Drain a user generator, shipping each yielded value to the
        owner as a stream_item (inline or via the local shm store). Sends
        the terminating stream_end; returns the item count (the sentinel
        result). Honors owner backpressure and cancel."""
        cancel = threading.Event()
        with self._active_streams_lock:
            self._active_streams[task_id] = cancel
        produced = 0
        acked = 0
        try:
            for value in gen:
                if cancel.is_set():
                    break
                oid = self.stream_item_oid(task_id, produced)
                head_payload, views, total = ser.serialize(value)
                loc = None
                if total <= INLINE_THRESHOLD:
                    buf = bytearray(total)
                    ser.write_into(memoryview(buf), head_payload, views)
                    frames = [bytes(buf)]
                else:
                    try:
                        mv = self._create_making_room(owner, oid, total)
                        ser.write_into(mv, head_payload, views)
                        del mv
                        self.store.seal(oid)
                        frames = [b""]
                        loc = {"address": self.nodelet_address,
                               "store_name": self.store.name, "size": total}
                    except KeyError:  # already present (retry replay)
                        frames = [b""]
                        loc = {"address": self.nodelet_address,
                               "store_name": self.store.name, "size": total}
                    except Exception:  # store full: ship inline
                        buf = bytearray(total)
                        ser.write_into(memoryview(buf), head_payload, views)
                        frames = [bytes(buf)]
                self.client.send_oneway(owner, "stream_item", {
                    "task_id": task_id, "index": produced, "oid": oid,
                    "location": loc, "producer": self.address,
                }, frames=frames)
                produced += 1
                if backpressure and produced - acked >= backpressure:
                    while not cancel.is_set():
                        try:
                            # justified GL014: this is the backpressure
                            # POLL loop — one round trip per poll IS the
                            # protocol (consumer progress is the reply);
                            # there is nothing to batch with. v2 index
                            # audit: GL014 is per-file by nature (loop
                            # shape, not reachability); the indexed
                            # engine adds no evidence either way, and
                            # the call is timeout-bounded (10s) with
                            # owner-gone cancellation on failure
                            # graftlint: disable=sequential-rpc-in-loop
                            r = self.client.call(owner, "stream_state",
                                                 {"task_id": task_id},
                                                 timeout=10)
                        except Exception:  # noqa: BLE001
                            cancel.set()  # owner gone: stop producing
                            break
                        if r.get("closed"):
                            cancel.set()
                            break
                        acked = max(acked, int(r.get("consumed", 0)))
                        if produced - acked < backpressure:
                            break
                        time.sleep(0.02)
        finally:
            if hasattr(gen, "close"):
                try:
                    gen.close()
                except Exception:  # noqa: BLE001
                    pass
            with self._active_streams_lock:
                self._active_streams.pop(task_id, None)
        self.client.send_oneway(owner, "stream_end",
                                {"task_id": task_id, "count": produced,
                                 "producer": self.address})
        return produced

    # ------------------------------------------------------------ normal tasks

    def _report_task_event(self, task_id: bytes, name: str, state: str,
                           t0: float, kind: str):
        """Buffered: per-task oneways to the head would dominate the hot
        path at >1k tasks/s (reference: task events are batched through
        the TaskEventBuffer, src/ray/core_worker/task_event_buffer.h)."""
        ev = {
            "task_id": task_id.hex(),
            "name": name,
            "state": state,
            "type": kind,
            "trace_id": (self._ctx.trace or {}).get("trace_id", ""),
            "duration_ms": round((time.monotonic() - t0) * 1e3, 2),
            "worker_id": self.worker_id_bytes.hex(),
            "node_id": self.node_id.hex() if self.node_id else "",
            "time": time.time(),
        }
        with self._event_buf_lock:
            self._event_buf.append(ev)
            flush = len(self._event_buf) >= 200
        if flush:
            self._flush_task_events()

    def _flush_task_events(self):
        with self._event_buf_lock:
            batch, self._event_buf = self._event_buf, []
        # raw spans ride the same oneway channel (reference: one
        # TaskEventBuffer stream carries status AND profile events),
        # identity-tagged by the shared drain helper so the head's
        # merged timeline lays them out as pid=node, tid=worker
        spans = self._drain_tagged_spans()
        if not batch and not spans:
            return
        try:
            self.client.send_oneway(self.head_address, "task_events",
                                    {"events": batch, "spans": spans})
        except Exception:
            # NOTE: oneways are best-effort by contract — send_oneway
            # swallows delivery failures itself, so a head outage loses
            # at most this flush window (bounded, and acceptable for
            # observability data). This guard only catches local
            # failures BEFORE the send (e.g. serialization), where
            # nothing was delivered. Requeueing is CAPPED: a poisoned
            # payload (unpicklable object smuggled into a span's trace
            # dict) must be dropped after a few attempts or it wedges
            # every future flush.
            self._flush_failures += 1
            if self._flush_failures <= 3:
                with self._event_buf_lock:
                    self._event_buf[:0] = batch
                self._events.requeue(spans)
        else:
            self._flush_failures = 0

    def _event_flush_loop(self):
        beat = 0
        while True:
            time.sleep(1.0)
            self._flush_task_events()
            # off the record() hot path: publish span kept/dropped
            # deltas into this worker's /metrics page once a second
            self._events.sync_metrics()
            beat += 1
            if beat % 5 == 0:
                self._refresh_span_policy()

    def _refresh_span_policy(self):
        """Adopt the head's span sampling policy (head-driven rate
        limits: one knob at the head throttles every producer when
        cluster span inflow crosses the cap). Best-effort — a dead head
        just leaves the current policy in place. Reinstall only on
        CHANGE: installing a policy resets token buckets and the
        first-seen set, so re-pushing an identical policy every poll
        would quietly defeat both."""
        try:
            r = self.client.call(self.head_address, "span_policy", {},
                                 timeout=2)
            policy = r.get("policy")
            if policy != getattr(self, "_last_span_policy", None):
                self._last_span_policy = policy
                self._events.configure_sampling(policy)
        except Exception:  # noqa: BLE001
            pass

    def _h_execute_task(self, msg, frames):
        self._exec_task_spec(TaskSpec(**msg["spec"]), notify_nodelet=True)
        self._done_batcher.flush()  # classic path: one task per dispatch

    def _h_set_lease(self, msg, frames):
        """Nodelet-driven lease handoff. A keyed clear only applies if the
        named lease is still current, so a clear racing a re-grant can
        never clobber the new lease."""
        clear = msg.get("clear")
        if clear is not None:
            if self._current_lease == clear:
                self._current_lease = None
        else:
            self._current_lease = msg["lease_id"]
        return {}

    def _h_execute_leased(self, msg, frames):
        """Enqueue-ack for a direct leased push — one frame carries a
        BATCH of specs (the refill pipeline's coalesced form; a single
        task is a batch of one). Dedup by (task_id, attempt): the
        owner's submit sweeper may resend the whole frame after a slow
        ack."""
        lid = msg.get("lease_id")
        if lid is not None and lid != self._current_lease:
            # stale push: the nodelet already re-credited this lease's
            # resources (TTL expiry / re-grant); running it would
            # oversubscribe the node (ADVICE r3). Owner resubmits classic.
            raise exc.StaleLeaseError("lease no longer held by this worker")
        specs = msg["specs"]
        attempts = msg.get("attempts") or [0] * len(specs)
        queued = 0
        with self._seen_lock:
            fresh = []
            for spec, attempt in zip(specs, attempts):
                key = spec["task_id"] + bytes([attempt & 0xFF])
                if key in self._seen_calls:
                    continue
                self._seen_calls.add(key)
                self._seen_calls_order.append(key)
                fresh.append(spec)
            if len(self._seen_calls_order) > 20000:
                for old in self._seen_calls_order[:10000]:
                    self._seen_calls.discard(old)
                del self._seen_calls_order[:10000]
        for spec in fresh:
            self._task_inbox.put(spec)
            queued += 1
        return {"queued": queued, "duplicate": queued < len(specs)}

    def _task_exec_loop(self):
        while True:
            spec = self._task_inbox.get()
            if spec is None:
                return
            self._exec_task_spec(TaskSpec(**spec), notify_nodelet=False)
            if self._task_inbox.empty():
                # inbox drained: ship buffered completions NOW (a lone
                # sync task's owner is already blocked in get())
                self._done_batcher.flush()

    def _exec_task_spec(self, spec: TaskSpec, notify_nodelet: bool):
        self._ctx.task_id = TaskID(spec.task_id)
        # adopt the submitter's trace context so spans of nested submits
        # link to this task (reference: tracing_helper.py:34 propagation)
        self._ctx.trace = spec.trace
        # log-plane attribution: structured records and captured prints
        # from this thread tag themselves with the task; the owner
        # address is the mirror target when RAY_TPU_LOG_TO_DRIVER is on
        self._ctx.task_name = spec.name
        self._ctx.task_owner = spec.owner
        t_start = time.monotonic()
        # ledger RUNNING transition: the queue→exec boundary seen from
        # the worker (one buffered dict append — noise-level cost)
        self._report_task_event(spec.task_id, spec.name, "RUNNING",
                                t_start, "NORMAL_TASK")
        # per-task CPU attribution: thread_time deltas on the executing
        # thread feed core_task_cpu_seconds_total{kind} + the cpu_stats
        # table (two clock reads per task — noise-level cost)
        t_cpu0 = time.thread_time()
        try:
            fn = self._fetch_fn(spec.fn_id)
            a, kw = self._decode_args(spec.args, spec.kwargs)
            if spec.streaming:
                with self._events.span(spec.name, "task", trace=spec.trace):
                    gen = fn(*a, **kw)
                    count = self._run_stream(spec.owner, spec.task_id, gen,
                                             spec.backpressure)
                self._ship_results(spec.owner, spec.task_id,
                                   spec.return_oids, [count])
                self._report_task_event(spec.task_id, spec.name, "FINISHED",
                                        t_start, "NORMAL_TASK")
                return
            with self._events.span(spec.name, "task", trace=spec.trace):
                result = fn(*a, **kw)
            n = len(spec.return_oids)
            if n == 0:
                values = []
            elif n == 1:
                values = [result]
            else:
                values = list(result)
                if len(values) != n:
                    raise ValueError(
                        f"task {spec.name} returned {len(values)} values, "
                        f"expected {n}")
            self._ship_results(spec.owner, spec.task_id, spec.return_oids, values)
            self._report_task_event(spec.task_id, spec.name, "FINISHED",
                                    t_start, "NORMAL_TASK")
        except Exception as e:  # noqa: BLE001
            err = exc.TaskError.from_exception(e, spec.name)
            retryable = _matches_retry(e, spec.retry_exceptions)
            self._ship_error(spec.owner, spec.task_id, spec.return_oids, err,
                             retryable)
            self._report_task_event(spec.task_id, spec.name, "FAILED",
                                    t_start, "NORMAL_TASK")
        finally:
            self._cpu_account(spec.name, "task",
                              time.thread_time() - t_cpu0)
            self._ctx.task_id = None
            self._ctx.task_name = None
            self._ctx.task_owner = None
            if notify_nodelet:
                try:
                    self.client.send_oneway(self.nodelet_address,
                                            "task_finished",
                                            {"worker_id": self.worker_id_bytes})
                except Exception:
                    pass

    # ------------------------------------------------------------ actors

    def _h_become_actor(self, msg, frames):
        spec = ActorSpec(**msg["spec"])
        spec.cls_blob = frames[0]
        self._actor_spec = spec
        self._ctx.actor_id = ActorID(spec.actor_id)
        try:
            cls = ser.loads_fn(spec.cls_blob)
            a, kw = self._decode_args(spec.args, spec.kwargs)
            self._actor_instance = cls(*a, **kw)
        except Exception as e:  # noqa: BLE001
            cause = f"__init__ failed: {e}\n{traceback.format_exc()}"
            try:
                self.client.call(self.head_address, "actor_died",
                                 {"actor_id": spec.actor_id, "cause": cause,
                                  "no_restart": True}, timeout=10)
            except Exception:
                pass
            os._exit(1)
        # per-group scheduling queues (reference: ConcurrencyGroupManager,
        # core_worker/transport/concurrency_group_manager.h:34 — each
        # named group has its own executor pool so a slow group cannot
        # block another; the unnamed default group uses max_concurrency)
        groups = {"_default": max(1, spec.max_concurrency)}
        for g, n in (spec.concurrency_groups or {}).items():
            groups[g] = max(1, int(n))
        # a plain max_concurrency=1 actor is guaranteed one-method-at-a-
        # time; compiled-DAG loops run on their own threads and must
        # honor that via this shared lock (no-op for concurrent actors)
        self._serial_actor = (max(1, spec.max_concurrency) == 1
                              and not spec.concurrency_groups)
        self._instance_lock = threading.Lock()
        self._actor_groups = {}
        for g, n_threads in groups.items():
            q: _queue.Queue = _queue.Queue()
            self._actor_groups[g] = q
            for _ in range(n_threads):
                threading.Thread(target=self._actor_exec_loop, args=(q,),
                                 daemon=True,
                                 name=f"actor-exec-{g}").start()
        self._async_loop = None  # created on first async method call
        self.client.send_oneway(self.head_address, "actor_ready",
                                {"actor_id": spec.actor_id,
                                 "address": self.address})

    def _h_actor_call(self, msg, frames):
        if self._actor_spec is None:
            raise exc.ActorUnavailableError("not an actor worker")
        task_id = msg.get("task_id") or b""
        if task_id:
            with self._seen_lock:
                if task_id in self._seen_calls:
                    return {"queued": True, "duplicate": True}
                self._seen_calls.add(task_id)
                self._seen_calls_order.append(task_id)
                if len(self._seen_calls_order) > 20000:
                    for old in self._seen_calls_order[:10000]:
                        self._seen_calls.discard(old)
                    del self._seen_calls_order[:10000]
        group = msg.get("concurrency_group") or "_default"
        q = self._actor_groups.get(group)
        if q is None:
            q = self._actor_groups["_default"]
        q.put(msg)
        return {"queued": True}

    def _h_actor_calls(self, msg, frames):
        """Batched actor_call frames from one owner's submit coalescer:
        one dispatch enqueues N calls in submission order (the
        per-actor ordering the coalescer preserves end to end)."""
        for m in msg["calls"]:
            self._h_actor_call(m, [])
        return {"queued": len(msg["calls"])}

    def _ensure_async_loop(self):
        """Dedicated asyncio loop thread for `async def` actor methods
        (reference: async actors run on an event loop and complete OUT OF
        ORDER, core_worker/transport/out_of_order_actor_scheduling_queue.h).
        Locked: concurrent first calls from different group executors
        must share ONE loop (two loops break asyncio primitives bound to
        the first)."""
        with self._async_loop_lock:
            if self._async_loop is None:
                import asyncio

                loop = asyncio.new_event_loop()
                threading.Thread(target=loop.run_forever, daemon=True,
                                 name="actor-async-loop").start()
                self._async_loop = loop
            return self._async_loop

    def _actor_exec_loop(self, inbox: _queue.Queue):
        # execution threads carry the actor identity so user code can ask
        # get_runtime_context() (reference: worker context per thread)
        self._ctx.actor_id = ActorID(self._actor_spec.actor_id)
        import asyncio
        import inspect

        while True:
            msg = inbox.get()
            if msg is None:
                return
            owner = msg["owner"]
            oids = msg["oids"]
            mname = msg["method"]
            task_id = msg.get("task_id", b"")
            self._ctx.task_id = TaskID(task_id) if task_id else None
            self._ctx.trace = msg.get("trace")
            t_start = time.monotonic()
            # CPU attribution per method call (async methods account
            # only their dispatch sliver — the coroutine body runs on
            # the shared event loop, where thread_time would attribute
            # OTHER coroutines' work to this call)
            t_cpu0 = time.thread_time()
            label = f"{type(self._actor_instance).__name__}.{mname}"
            # log-plane attribution for this method execution (async
            # bodies run on the shared event loop and stay unattributed
            # — same boundary as CPU attribution's dispatch sliver)
            self._ctx.task_name = label
            self._ctx.task_owner = owner
            if task_id:
                self._report_task_event(task_id, label, "RUNNING",
                                        t_start, "ACTOR_TASK")
            try:
                a, kw = self._decode_args(msg["args"], msg["kwargs"])
                fn = getattr(self._actor_instance, mname)
                if msg.get("streaming"):
                    if inspect.iscoroutinefunction(fn) or \
                            inspect.isasyncgenfunction(fn):
                        raise TypeError(
                            f"{mname}: async streaming actor methods are "
                            f"not supported; use a sync generator")
                    # the stream occupies this method slot until drained
                    # (serial actors stay one-method-at-a-time throughout)
                    with self._events.span(label, "actor_task",
                                           trace=msg.get("trace")):
                        if self._serial_actor:
                            with self._instance_lock:
                                gen = fn(*a, **kw)
                                count = self._run_stream(
                                    owner, task_id, gen,
                                    msg.get("backpressure", 0))
                        else:
                            gen = fn(*a, **kw)
                            count = self._run_stream(
                                owner, task_id, gen,
                                msg.get("backpressure", 0))
                    self._ship_results(owner, task_id, oids, [count])
                    self._report_task_event(task_id, label, "FINISHED",
                                            t_start, "ACTOR_TASK")
                    continue
                if inspect.iscoroutinefunction(fn):
                    # async method: schedule on the event loop and move on
                    # — completions land out of submission order while
                    # this group's thread keeps draining its queue
                    loop = self._ensure_async_loop()
                    fut = asyncio.run_coroutine_threadsafe(
                        fn(*a, **kw), loop)
                    fut.add_done_callback(
                        self._make_async_done(owner, task_id, oids, label,
                                              t_start))
                    continue
                with self._events.span(label, "actor_task",
                                       trace=msg.get("trace")):
                    if self._serial_actor:
                        with self._instance_lock:
                            result = fn(*a, **kw)
                    else:
                        result = fn(*a, **kw)
                n = len(oids)
                values = [result] if n == 1 else (list(result) if n else [])
                self._ship_results(owner, task_id, oids, values)
                self._report_task_event(task_id, label, "FINISHED", t_start,
                                        "ACTOR_TASK")
            except Exception as e:  # noqa: BLE001
                err = exc.TaskError.from_exception(e, label)
                self._ship_error(owner, task_id, oids, err)
                self._report_task_event(task_id, label, "FAILED", t_start,
                                        "ACTOR_TASK")
            finally:
                self._cpu_account(label, "actor",
                                  time.thread_time() - t_cpu0)
                self._ctx.task_name = None
                self._ctx.task_owner = None
                if inbox.empty():
                    # group inbox drained: callers are (about to be)
                    # blocked on these results — flush buffered dones
                    self._done_batcher.flush()

    def _make_async_done(self, owner, task_id, oids, label, t_start):
        def done(fut):
            try:
                result = fut.result()
                n = len(oids)
                values = [result] if n == 1 else (list(result) if n else [])
                self._ship_results(owner, task_id, oids, values)
                self._report_task_event(task_id, label, "FINISHED", t_start,
                                        "ACTOR_TASK")
            except Exception as e:  # noqa: BLE001
                err = exc.TaskError.from_exception(e, label)
                self._ship_error(owner, task_id, oids, err)
                self._report_task_event(task_id, label, "FAILED", t_start,
                                        "ACTOR_TASK")
            finally:
                # async completions land outside any exec-loop idle
                # check: flush unconditionally (out-of-order callers
                # may already be blocked on exactly this result)
                self._done_batcher.flush()

        return done

    # ------------------------------------------------------------ compiled DAG
    # Reference: accelerated/compiled DAGs (dag/compiled_dag_node.py:711)
    # — after compile, repeated executions bypass task submission
    # entirely: each actor runs a resident loop reading its input
    # CHANNELS, invoking the bound method directly on the hosted
    # instance, and writing the result channel.

    def _h_dag_start(self, msg, frames):
        from ray_tpu_torch.experimental.channel import Channel

        if self._actor_instance is None:
            raise exc.ActorUnavailableError("not an actor worker")
        loop_id = msg["loop_id"]
        method = msg["method"]
        ins = [Channel(name=n, create=False) for n in msg["in_channels"]]
        out = Channel(name=msg["out_channel"], create=False)
        stop = threading.Event()
        self._dag_loops[loop_id] = stop

        # per-stage attribution: SPSC channels deliver executions in
        # seq order through every stage, so a local counter IS the
        # execution's seq — each stage's span joins the driver's
        # dag.execute span under one synthetic trace_id per execution
        prefix, _, stage = loop_id.rpartition("_")
        span_name = f"dag.{method}:{stage}"

        def run():
            fn = getattr(self._actor_instance, method)
            n_exec = 0
            while not stop.is_set():
                try:
                    # short poll on the FIRST input (checks `stop`); once
                    # one arg of an execution landed the rest are in
                    # flight, so wait them out fully — a short timeout
                    # there would drop the already-consumed first arg
                    first = ins[0].get(timeout=0.5)
                except TimeoutError:
                    continue
                except Exception:  # noqa: BLE001
                    return  # channel closed/destroyed: loop ends
                try:
                    args = [first] + [c.get(timeout=60) for c in ins[1:]]
                except Exception:  # noqa: BLE001
                    return
                dag_trace = {"trace_id": f"dag:{prefix}:{n_exec}"}
                n_exec += 1
                # an upstream stage's error marker passes through
                # UNCHANGED (it consumes one slot per stage, so sequence
                # numbers stay aligned and the driver re-raises the
                # ORIGINAL error — same propagation as an eager chain)
                marker = next((a for a in args
                               if isinstance(a, dict)
                               and "__dag_error__" in a), None)
                try:
                    if marker is not None:
                        out.put(marker)
                        continue
                    if getattr(self, "_serial_actor", False):
                        with self._instance_lock, \
                                self._events.span(span_name, "dag",
                                                  trace=dag_trace):
                            result = fn(*args)
                    else:
                        with self._events.span(span_name, "dag",
                                               trace=dag_trace):
                            result = fn(*args)
                    out.put(result)
                except Exception as e:  # noqa: BLE001
                    # ship the same TaskError the eager path would raise
                    # at get(); fall back to a repr if it won't pickle
                    err = exc.TaskError.from_exception(e, f"dag:{method}")
                    try:
                        out.put({"__dag_error__": err})
                    except Exception:  # noqa: BLE001
                        try:
                            out.put({"__dag_error__": f"{method}: {e!r}"})
                        except Exception:  # noqa: BLE001
                            return

        threading.Thread(target=run, daemon=True,
                         name=f"dag-loop-{method}").start()
        return {"ok": True}

    def _h_dag_stop(self, msg, frames):
        stop = self._dag_loops.pop(msg["loop_id"], None)
        if stop is not None:
            stop.set()
        return {"ok": True}

    def _h_exit(self, msg, frames):
        try:
            self._done_batcher.flush()  # don't strand buffered results
            self.client.flush_oneways()
        except Exception:  # noqa: BLE001
            pass
        os._exit(0)


def _matches_retry(e, retry_exceptions) -> bool:
    if retry_exceptions is True:
        return True
    if isinstance(retry_exceptions, (list, tuple)):
        return isinstance(e, tuple(retry_exceptions))
    return False


def _exit_when_orphaned(nodelet_pid: int) -> None:
    """Exit once the nodelet's process is gone: it is this one's parent
    until then."""
    while True:
        time.sleep(0.5)
        if os.getppid() != nodelet_pid:
            os._exit(0)


def main():
    pid = os.environ.get("RAY_TPU_NODELET_PID")
    if pid:
        # watched from the start, not only once registered: a worker
        # spawned as its nodelet stops must not outlive it by the length
        # of its start-up
        threading.Thread(target=_exit_when_orphaned, args=(int(pid),),
                         daemon=True, name="orphan-check").start()
    t0 = time.monotonic()
    try:
        rt = WorkerRuntime()
        _set_runtime(rt)
    except Exception:  # noqa: BLE001
        # the nodelet or its store is gone: nothing to register with
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    # structured log plane: every logging call in this process lands in
    # the node's JSONL log dir with task/trace attribution, and raw
    # prints are captured (attributed, optionally mirrored to the
    # submitting driver — the one-bool RAY_TPU_LOG_TO_DRIVER path)
    from ray_tpu_torch.core import config as cfg
    from ray_tpu_torch.utils import logging as slog

    session_dir = os.environ.get("RAY_TPU_SESSION_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu")
    slog.install_process_logging(
        role="worker",
        log_dir=os.path.join(session_dir, "logs"),
        node_id=os.environ.get("RAY_TPU_NODE_ID", "")[:12],
        proc=os.environ.get("RAY_TPU_WORKER_ID", "")[:12])
    slog.install_stream_capture(
        mirror_fn=rt._mirror_stream_line
        if cfg.get("LOG_TO_DRIVER") else None)
    try:
        rt.client.call(rt.nodelet_address, "worker_ready",
                       {"worker_id": rt.worker_id_bytes,
                        "address": rt.address}, timeout=30, retries=3)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    import logging as _logging

    _logging.getLogger("ray_tpu_torch.worker").info(
        "worker ready in %.3fs", time.monotonic() - t0)
    # stay alive while the nodelet answers
    misses = 0
    while True:
        time.sleep(2)
        try:
            rt.client.call(rt.nodelet_address, "ping", {}, timeout=5)
            misses = 0
        except Exception:
            misses += 1
            if misses >= 3:
                os._exit(0)


if __name__ == "__main__":
    main()
