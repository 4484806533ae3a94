"""ClusterRuntime — the in-process runtime for drivers AND workers.

Reference parity: CoreWorker (src/ray/core_worker/core_worker.h:166).
Like the reference, every process (driver or worker) runs the same
runtime: it owns the objects it creates (ownership model from the
"Ownership" paper, reference README.rst:75-76), submits tasks to its
local nodelet, receives results DIRECTLY from executing workers
(worker→owner RPC, bypassing head and nodelet — the decentralized hot
path), and serves object resolution to borrowers.

Object plane:
- results ≤ INLINE_THRESHOLD ride inline in the worker→owner task_done
  message (reference: small returns go to the owner's in-process memory
  store, core_worker.cc ExecuteTask);
- larger results live in the executing node's shm store; the owner
  records the location; `get` pulls them into the local store via the
  nodelet (PullManager equivalent) and reads zero-copy.

The port's copy of ``ray_tpu/core/cluster_runtime.py``. Functions and
actor classes travel pickled by value (serialization.dumps_fn) in place
of cloudpickle; a booted node asserts the GPUs this process may use
(``init(num_gpus=)`` overrides the count) where the JAX package detects
TPU chips. Not ported yet, and raising NotImplementedError when asked
for: the log plane's mirror of worker prints to the driver
(RAY_TPU_LOG_TO_DRIVER), this process's metrics page (metrics_text) and
the profiler (profile_capture).
"""

from __future__ import annotations

import atexit
import hashlib
import os
import random
import tempfile
import threading
import time
from typing import Any, Callable

from ray_tpu_torch.core import exceptions as exc
from ray_tpu_torch.core import runtime_env as rtenv
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.api import ActorHandle, ObjectRef
from ray_tpu_torch.core.head import dataclass_dict
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import open_store
from ray_tpu_torch.core.options import ActorOptions, TaskOptions
from ray_tpu_torch.core.rpc import (
    Batcher,
    PeerUnavailableError,
    RpcClient,
    RpcServer,
)
from ray_tpu_torch.core.specs import INLINE_THRESHOLD, ActorSpec, RefArg, TaskSpec
from ray_tpu_torch.utils.events import TaskEventLog, child_trace, merge_spans


class _StoreHold:
    """One read hold on a store object, taken by a zero-copy read
    (plasma's client-side buffer). The out-of-band buffers of the value
    read reference it, and so does the ref's pin: the store gets the
    hold back only when the ref and every array or tensor aliasing the
    bytes are gone, so no later object can reuse them under a value."""

    __slots__ = ("store", "oid")

    def __init__(self, store, oid: bytes):
        self.store = store
        self.oid = oid

    def __del__(self):
        self.store.release(self.oid)


class _Owned:
    """State of an object this process owns."""

    __slots__ = ("event", "inline", "value_cached", "has_cached", "location",
                 "store_name", "error", "spec", "retries_left", "borrowers",
                 "cancelled", "size", "spilled_path", "created_at", "label",
                 "consumed")

    def __init__(self, spec: TaskSpec | None = None, retries_left: int = 0,
                 label: str | None = None):
        self.event = threading.Event()
        self.inline: bytes | None = None
        self.value_cached = None
        self.has_cached = False
        self.location: str | None = None  # nodelet address holding the bytes
        self.store_name: str | None = None
        self.error: BaseException | None = None
        self.spec = spec
        self.retries_left = retries_left
        self.size = 0  # serialized bytes (locality scoring)
        self.spilled_path: str | None = None  # disk tier (spilled primary)
        # memory-attribution facts (the `ray_tpu memory` / stranded-ref
        # auditor substrate): when the ref was born, WHAT created it
        # (task/method name, or put/deferred), and whether any consumer
        # ever made progress on it (a local get, or serving a borrower's
        # resolve). A ready-but-never-consumed ref past the age
        # threshold is the stranded shape the PR-11 traceback pin leaked.
        self.created_at = time.monotonic()
        self.label = label or (spec.name if spec is not None else "put")
        self.consumed = False
        # borrowing processes: rpc address -> borrow EPOCH. The epoch
        # makes deferred releases safe: a stale release from a previous
        # borrow lifecycle of the same process cannot unregister a newer
        # borrow (reference: borrower bookkeeping,
        # core_worker/reference_count.h:66)
        self.borrowers: dict[str, int] = {}
        self.cancelled = False


class _StreamState:
    """Owner-side bookkeeping for one streaming-generator task
    (reference: ObjectRefStream, src/ray/core_worker/task_manager.h:104).

    Items arrive as stream_item oneways from the producer (ZeroMQ orders
    them before the terminating stream_end on the same connection); the
    consumer — local generator handle or a remote borrower via the
    stream_next RPC — blocks on `cond` for the next index. `consumed`
    feeds producer backpressure."""

    __slots__ = ("cond", "items", "end", "error", "consumed", "closed",
                 "producer", "sentinel")

    def __init__(self, sentinel: bytes):
        self.cond = threading.Condition()
        self.items: dict[int, bytes] = {}  # index -> item oid
        self.end: int | None = None        # total count once producer done
        self.error: BaseException | None = None
        self.consumed = 0                  # indices handed to the consumer
        self.closed = False
        self.producer: str | None = None   # producer rpc address (cancel)
        self.sentinel = sentinel           # return_oids[0] of the task


class _Context(threading.local):
    def __init__(self):
        self.actor_id = None
        self.task_id = None
        # active trace context (OTel-style span propagation — reference:
        # tracing_helper.py:34 _inject_tracing_into_function)
        self.trace = None
        # log-plane attribution for the executing thread: the task's
        # display label and its owner's address (the mirror target for
        # captured prints when RAY_TPU_LOG_TO_DRIVER is armed)
        self.task_name = None
        self.task_owner = None


# span-context derivation lives with the event log now (utils/events.py)
# so the local runtime and the user span API share one implementation
_child_trace = child_trace


class _HeldLease:
    """Submitter-side record of a leased worker (reference: lease reuse,
    core_worker/transport/normal_task_submitter.cc:137)."""

    __slots__ = ("lease_id", "worker_id", "address", "inflight",
                 "last_active", "broken", "key", "nodelet")

    def __init__(self, lease_id, worker_id, address, key, nodelet):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.address = address
        self.inflight: set[bytes] = set()  # task_ids pushed, not yet done
        self.last_active = time.monotonic()
        self.broken = False
        self.key = key
        self.nodelet = nodelet  # which nodelet granted (return/renew here)


# max in-flight pushes per leased worker: enough buffered at the worker
# to keep the wire full AND let refills ride one batched frame, without
# committing the whole backlog to a single worker (excess waits
# CLIENT-side where it can still move to newly granted leases on other
# nodes). Config LEASE_PIPELINE_DEPTH.
def _lease_depth() -> int:
    from ray_tpu_torch.core import config as cfg

    return max(1, int(cfg.get("LEASE_PIPELINE_DEPTH")))


_LEASE_IDLE_RETURN_S = 2.0

# core_submit_coalesced_total{kind}: items that rode a coalesced frame
# (lazy-constructed: this module loads before the metrics package can)
_coalesced_counter = None
_coalesced_lock = threading.Lock()


def _submit_coalesced(kind: str, n: int):
    global _coalesced_counter
    if _coalesced_counter is None:
        with _coalesced_lock:
            if _coalesced_counter is None:
                try:
                    from ray_tpu_torch.util.metrics import Counter

                    _coalesced_counter = Counter(
                        "core_submit_coalesced_total",
                        "submissions/returns that rode a coalesced "
                        "batch frame, by kind",
                        tag_keys=("kind",))
                except Exception:  # noqa: BLE001
                    return
    try:
        _coalesced_counter.inc(n, {"kind": kind})
    except Exception:  # noqa: BLE001
        pass


def _ack_timeout() -> float:
    from ray_tpu_torch.core import config as cfg

    return cfg.get("ACK_TIMEOUT_S")


# core_task_cpu_seconds_total{kind}: CPU time attributed to task /
# actor-method execution (lazy-constructed like _coalesced_counter)
_task_cpu_counter = None
_task_cpu_lock = threading.Lock()


def _task_cpu_observe(kind: str, cpu_s: float):
    global _task_cpu_counter
    if _task_cpu_counter is None:
        with _task_cpu_lock:
            if _task_cpu_counter is None:
                try:
                    from ray_tpu_torch.util.metrics import Counter

                    _task_cpu_counter = Counter(
                        "core_task_cpu_seconds_total",
                        "CPU seconds consumed executing tasks and actor "
                        "methods, by kind", tag_keys=("kind",))
                except Exception:  # noqa: BLE001
                    return
    try:
        _task_cpu_counter.inc(max(0.0, cpu_s), {"kind": kind})
    except Exception:  # noqa: BLE001
        pass


def _stranded_age_s() -> float:
    """Age past which a ready-but-never-consumed owned ref counts as
    stranded (the auditor threshold; env-tunable for tests/ops)."""
    try:
        return float(os.environ.get("RAY_TPU_STRANDED_AGE_S", "300"))
    except ValueError:
        return 300.0


def is_stranded(ready: bool, consumed: bool, borrowers: int,
                age_s: float, threshold_s: float) -> bool:
    """THE stranded-ref predicate — the ONE definition shared by the
    owner-side auditor (the `object_store_stranded_bytes` gauge the
    watchtower rule watches) and the state API's memory report, so the
    alert and the report operators chase it with can never disagree
    about what counts as stranded: ready, past the age threshold, and
    no consumer progress (never consumed, no live borrower)."""
    return (bool(ready) and not consumed and not borrowers
            and age_s >= threshold_s)


class ClusterRuntime:
    def __init__(self, address: str | None = None, num_cpus=None, num_gpus=None,
                 resources=None, namespace=None, labels=None, mode="driver",
                 head=None, nodelet=None, store_capacity=None, **_):
        self.mode = mode
        self.namespace = namespace or "default"
        self.job_id = JobID.random()
        self.worker_id = WorkerID.random()
        self._ctx = _Context()
        self._events = TaskEventLog()
        self.client = RpcClient.shared()
        self._lock = threading.RLock()
        self._owned: dict[bytes, _Owned] = {}  # guarded_by(_lock)
        self._refcounts: dict[bytes, int] = {}  # guarded_by(_lock)
        self._fn_cache: dict[str, Callable] = {}  # guarded_by(_lock)
        self._exported_fns: set[str] = set()  # guarded_by(_lock)
        import weakref

        self._fn_id_cache = weakref.WeakKeyDictionary()  # fn -> fn_id
        self._actor_addr: dict[bytes, str] = {}  # guarded_by(_lock)
        self._actor_meta: dict[bytes, dict] = {}  # guarded_by(_lock)
        # in-flight actor calls by actor: when an actor dies/restarts, its
        # pending calls must fail fast with ActorDiedError instead of
        # leaving the owner waiting forever (reference: ActorTaskSubmitter
        # DisconnectActor fails inflight tasks, actor_task_submitter.h:75)
        self._inflight_actor: dict[bytes, dict[bytes, list[bytes]]] = {}  # guarded_by(_lock)
        # task_id -> actor_id; guarded_by(_lock)
        self._task_actor: dict[bytes, bytes] = {}
        # objects we borrow (store bytes owned elsewhere): oid -> owner;
        # guarded_by(_lock)
        self._borrowed_owner: dict[bytes, str] = {}
        # oid -> epoch of the ACTIVE borrow lifecycle (popped on release
        # so the dict never outgrows the live borrow set); epochs come
        # from one global monotonic counter so a re-borrow always
        # outranks any earlier queued release
        self._borrow_epoch: dict[bytes, int] = {}  # guarded_by(_lock)
        self._borrow_epoch_counter = 0  # guarded_by(_lock)
        self._rtenv_cache: dict = {}  # normalized runtime envs by content
        # what this owner moved to the disk tier: objects, bytes, seconds
        self.spill_stats = {"objects": 0, "bytes": 0, "seconds": 0.0}
        # one spill pass at a time: producers' spill_requests run on the
        # RPC pool beside this owner's own puts
        self._spill_lock = threading.Lock()
        # Store holds of objects a deserialized graph aliases zero-copy
        # (plasma pin semantics): the ref's share, dropped when the
        # object is freed or at shutdown. The values hold their own.
        self._pins: dict[bytes, _StoreHold] = {}  # guarded_by(_lock)
        # Refs riding as args of in-flight tasks hold a reference until
        # the task reaches a terminal state (reference: TaskManager
        # "submitted task references", core_worker/task_manager.h:212).
        self._task_arg_refs: dict[bytes, list[bytes]] = {}  # guarded_by(_lock)
        self._booted = []  # in-process services we own (head/nodelet)
        self._shutdown_flag = False
        # worker-lease reuse + pipelined submission state
        self._lease_pools: dict[tuple, list] = {}  # guarded_by(_lock)
        self._lease_pending: dict[tuple, list] = {}  # guarded_by(_lock)
        # task_id -> (lease, spec); guarded_by(_lock)
        self._task_lease: dict[bytes, tuple] = {}
        # in-flight submission acks: [deadline, future, resend_fn,
        # fail_fn]; guarded_by(_lock)
        self._pending_acks: list = []
        # task lifecycle ledger outbox (SUBMITTED/LEASED/RETRIED
        # transitions from this owner), drained to the head's
        # task_events lane by the submit sweeper. Capped with drops
        # counted — a head outage must not grow this without bound.
        self._ledger_buf: list = []  # guarded_by(_lock)
        self._ledger_drops = 0  # guarded_by(_lock)
        # gc-driven oneways (frees/borrow releases) flushed by the sweeper
        from collections import deque as _deque

        self._deferred_sends: _deque = _deque()
        # per-key lease cap: bounds CLUSTER-wide workers one submitter can
        # hold, not this process's cores — nodelet denials (with 50ms
        # negative caching) are the real admission control
        self._lease_cap = 64
        self._lease_backoff: dict[tuple, float] = {}  # guarded_by(_lock)
        self._last_renew = 0.0
        self._last_backlog = 0

        # streaming-generator streams we own, keyed by producing task_id
        self._streams: dict[bytes, _StreamState] = {}  # guarded_by(_lock)
        # submit-side coalescer: pending task/actor-call submissions to
        # the same peer pack into ONE batched RPC frame (adaptive flush:
        # size-capped inline, idle window, and force-flushed by every
        # path about to block on a result)
        self._submit_batcher = Batcher(f"rt-{mode}-submit",
                                       self._flush_submit_batch)
        self.server = RpcServer(name=f"rt-{mode}", num_threads=32)
        self.server.register("lease_broken", self._h_lease_broken,
                             oneway=True)
        self.server.register("task_done", self._h_task_done, oneway=True)
        self.server.register("task_done_batch", self._h_task_done_batch,
                             oneway=True)
        self.server.register("resolve", self._h_resolve)
        self.server.register("stream_item", self._h_stream_item, oneway=True)
        self.server.register("stream_end", self._h_stream_end, oneway=True)
        self.server.register("stream_next", self._h_stream_next)
        self.server.register("stream_state", self._h_stream_state)
        self.server.register("stream_close", self._h_stream_close,
                             oneway=True)
        self.server.register("borrow_release", self._h_borrow_release,
                             oneway=True)
        self.server.register("pubsub", self._h_pubsub, oneway=True)
        # slow lane: spilling writes whole objects to the disk tier
        self.server.register("spill_request", self._h_spill_request,
                             slow=True)
        self.server.register("list_objects", self._h_list_objects)
        self.server.register("metrics_text", self._h_metrics_text)
        # profiler plane: capture handlers block for their window, so
        # they ride the slow lane; cpu_stats is a cheap table read
        self.server.register("profile_capture", self._h_profile_capture,
                             slow=True)
        self.server.register("cpu_stats", self._h_cpu_stats)
        self.server.register("ping", lambda m, f: "pong")
        # per-task CPU attribution table: (label, kind) -> [cpu_s, calls]
        # fed by the worker exec loop via _cpu_account, read by the
        # cpu_stats RPC (bounded: overflow folds into "_other")
        self._cpu_by_label: dict[tuple, list] = {}  # guarded_by(_cpu_lock)
        self._cpu_lock = threading.Lock()
        self.address = self.server.address

        if mode == "driver":
            from ray_tpu_torch.core import config as cfg

            if cfg.get("LOG_TO_DRIVER"):
                raise NotImplementedError(
                    "RAY_TPU_LOG_TO_DRIVER: the structured log plane is not "
                    "ported to ray_tpu_torch yet; a worker's prints are in "
                    "its log file under the session's logs/")
            self._boot_or_connect(address, num_cpus, num_gpus, resources or {},
                                  labels or {}, store_capacity)
            atexit.register(self.shutdown)
        # worker mode: worker_main wires head/nodelet/store explicitly
        elif head is not None:
            self.head_address = head
            self.nodelet_address = nodelet
            self.node_id = None
            self.store = None
        self.server.start()
        threading.Thread(target=self._submit_sweeper, daemon=True,
                         name=f"rt-{mode}-sweep").start()
        # actor lifecycle events keep the address cache + arg pins fresh
        try:
            self.client.call(self.head_address, "subscribe",
                             {"topics": ["actor"], "address": self.address},
                             timeout=10)
        except Exception:
            pass

    # ------------------------------------------------------------ boot

    def _boot_or_connect(self, address, num_cpus, num_gpus, resources, labels,
                         store_capacity):
        from ray_tpu_torch.accelerators import NvidiaGPUAcceleratorManager
        from ray_tpu_torch.core.head import Head
        from ray_tpu_torch.core.nodelet import Nodelet

        if address is None:
            session = f"session_{int(time.time())}_{os.getpid()}"
            session_dir = os.path.join(tempfile.gettempdir(), "ray_tpu",
                                       session)
            os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
            head = Head(session_name=session).start()
            self._booted.append(head)
            res = dict(resources)
            res.setdefault("CPU", float(num_cpus if num_cpus is not None
                                        else os.cpu_count() or 4))
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            else:
                ngpu = NvidiaGPUAcceleratorManager \
                    .get_current_node_num_accelerators()
                if ngpu:
                    res["GPU"] = float(ngpu)
            nodelet = Nodelet(head.address, res, labels=labels,
                              session_dir=session_dir,
                              store_capacity=store_capacity).start()
            self._booted.append(nodelet)
            self.head_address = head.address
            self.session_dir = session_dir
        else:
            self.head_address = address
            self.session_dir = os.path.join(tempfile.gettempdir(), "ray_tpu")
            self.client.call(self.head_address, "ping", {}, timeout=10, retries=3)
        # attach to a local nodelet (lowest node = first registered)
        view = self.client.call(self.head_address, "cluster_view", {}, timeout=10)
        if not view["nodes"]:
            raise RuntimeError("no nodes in cluster")
        node = view["nodes"][0]
        self.nodelet_address = node["address"]
        self.node_id = NodeID(node["node_id"])
        self.store = open_store(name=node["store_name"], create=False)

    # ------------------------------------------------------------ refcounting

    def _incref(self, oid, owner: str | None = None):
        b = oid.binary() if hasattr(oid, "binary") else oid
        with self._lock:
            self._refcounts[b] = self._refcounts.get(b, 0) + 1

    def _decref(self, oid, owner: str | None = None):
        b = oid.binary() if hasattr(oid, "binary") else oid
        with self._lock:
            c = self._refcounts.get(b, 0) - 1
            if c > 0:
                self._refcounts[b] = c
                return
            self._refcounts.pop(b, None)
            st = self._owned.get(b)
            if st is None:
                # not ours: if we registered a borrow, tell the owner the
                # last local reference is gone (reference: borrower->owner
                # release, core_worker/reference_count.h:66). The pin
                # release and the network send happen OUTSIDE the lock —
                # _decref runs at arbitrary GC points.
                borrowed_from = self._borrowed_owner.pop(b, None)
            else:
                if not st.event.is_set() or st.borrowers:
                    return  # pending / actively borrowed objects stay
                self._owned.pop(b, None)
                borrowed_from = None
        self._release_pin(b)
        if st is not None:
            self._free_remote_bytes(st, b)
        elif borrowed_from is not None:
            # DEFERRED: _decref runs from __del__ at arbitrary gc points —
            # a gc firing between another send's multipart frames must not
            # interleave a new message on the same socket. The sweeper
            # flushes these from its own thread; the EPOCH lets the owner
            # ignore this release if we re-borrow the oid before it lands.
            # Epoch pop ends the lifecycle; append is under the lock so
            # the entry can never land on an orphaned queue.
            with self._lock:
                epoch = self._borrow_epoch.pop(b, 0)
                self._deferred_sends.append(
                    (borrowed_from, "borrow_release",
                     {"oid": b, "borrower": self.address, "epoch": epoch}))

    def _free_remote_bytes(self, st: "_Owned", b: bytes):
        if st.spilled_path is not None:
            try:
                os.unlink(st.spilled_path)
            except OSError:
                pass
            st.spilled_path = None
            return
        with self._lock:
            if st.location is not None and self.nodelet_address:
                target = (self.nodelet_address if st.location == "local"
                          else st.location)
                # deferred for the same gc-reentrancy reason as above
                self._deferred_sends.append(
                    (target, "free_object", {"oid": b}))

    def _flush_deferred_sends(self):
        # drain under the lock (appenders hold it too), send outside it
        with self._lock:
            if not self._deferred_sends:
                return
            batch = list(self._deferred_sends)
            self._deferred_sends.clear()
        for target, method, msg in batch:
            try:
                self.client.send_oneway(target, method, msg)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------ objects

    def put(self, value) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed")
        oid = ObjectID.random()
        b = oid.binary()
        st = _Owned()
        self._seal_owned(st, b, value)
        st.event.set()
        with self._lock:
            self._owned[b] = st
        return ObjectRef(oid, owner=self.address)

    def deferred(self):
        """A promise: (ref, fulfill, reject). Registers an owned object
        whose value arrives later via the callbacks — the ref is
        get-able (and borrowable) immediately, blocking until sealed,
        exactly like a task-return oid awaiting task_done. Serve
        handles use this to front retried submits (failover relays)
        with one stable ref."""
        oid = ObjectID.random()
        b = oid.binary()
        st = _Owned(label="deferred")
        with self._lock:
            self._owned[b] = st

        def fulfill(value):
            self._seal_owned(st, b, value)
            st.event.set()

        def reject(e: BaseException):
            st.error = e
            st.event.set()

        return ObjectRef(oid, owner=self.address), fulfill, reject

    def _seal_owned(self, st: "_Owned", b: bytes, value) -> None:
        """Serialize `value` into an owned slot (inline or store tier)
        without setting its event — put()/deferred() own the visibility
        flip."""
        head_payload, views, total = ser.serialize(value)
        st.size = total
        if total <= INLINE_THRESHOLD or self.store is None:
            buf = bytearray(total)
            ser.write_into(memoryview(buf), head_payload, views)
            st.inline = bytes(buf)
        else:
            wrote = False
            for attempt in range(2):
                try:
                    buf = self.store.create(b, total)
                    ser.write_into(buf, head_payload, views)
                    del buf
                    self.store.seal(b)
                    st.location = "local"
                    st.store_name = self.store.name
                    wrote = True
                    break
                except Exception:  # noqa: BLE001
                    # store full: spill our own primary copies to the disk
                    # tier and retry once (reference: LocalObjectManager
                    # spilling, raylet/local_object_manager.h:41)
                    if attempt == 0 and not self._spill_primaries(total):
                        break
            if not wrote:
                buf = bytearray(total)
                ser.write_into(memoryview(buf), head_payload, views)
                st.inline = bytes(buf)
        st.value_cached = value
        st.has_cached = True

    # ------------------------------------------------------------ spilling
    # Owner-driven disk tier (reference: raylet LocalObjectManager,
    # local_object_manager.h:41 — spill pinned primaries under memory
    # pressure, restore on access; the owner tracks the spilled URL).
    # Ownership centralizes the metadata, so the owner is the natural
    # spill coordinator for its own primaries: the ones it put, and the
    # ones a producer wrote into the store this owner maps (a task's
    # result, a stream's item). A producer whose create does not fit asks
    # the owner to make room first (the port's spill_request; the JAX
    # package ships such an item inline to the owner instead).

    _SPILL_MIN_BYTES = 64 * 1024

    def _spill_dir(self) -> str:
        base = getattr(self, "session_dir", None) or \
            os.environ.get("RAY_TPU_SESSION_DIR") or \
            os.path.join(tempfile.gettempdir(), "ray_tpu")
        d = os.path.join(base, "spill", f"pid{os.getpid()}")
        os.makedirs(d, exist_ok=True)
        return d

    def _spill_primaries(self, nbytes_needed: int) -> int:
        """Spill oldest eligible local primaries until ~nbytes_needed of
        store space has been reclaimed. Returns bytes reclaimed. One pass
        at a time: two passes over one snapshot would both write an
        object's file, and the loser's clean-up would unlink the
        winner's."""
        if self.store is None:
            return 0
        with self._spill_lock:
            candidates = []
            with self._lock:
                for b, st in self._owned.items():
                    if (st.event.is_set()
                            and st.store_name == self.store.name
                            and st.spilled_path is None and not st.borrowers
                            and st.error is None
                            and st.size >= self._SPILL_MIN_BYTES
                            and b not in self._pins):
                        candidates.append((b, st))
            freed = 0
            spill_dir = None
            t0 = time.perf_counter()
            # dict order == insertion order: oldest first
            for b, st in candidates:
                if freed >= nbytes_needed:
                    break
                view = self.store.get(b)
                if view is None:
                    continue
                try:
                    if spill_dir is None:
                        spill_dir = self._spill_dir()
                    path = os.path.join(spill_dir, b.hex())
                    with open(path, "wb") as f:
                        f.write(view)
                except OSError:
                    del view
                    self.store.release(b)
                    return freed
                size = view.nbytes
                del view
                self.store.release(b)   # our read hold
                with self._lock:
                    # COMMIT point: _h_resolve registers borrowers under this
                    # same lock — re-check so we never delete shm bytes a
                    # just-registered borrower was promised (spill/borrow
                    # race), nor spill an object freed meanwhile
                    if st.borrowers or b in self._pins or \
                            self._owned.get(b) is not st:
                        committed = False
                    else:
                        committed = True
                        st.spilled_path = path
                        st.location = "spilled"
                        st.store_name = None
                        # drop the value cache: the point of spilling is
                        # releasing memory
                        st.value_cached = None
                        st.has_cached = False
                if not committed:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                self.store.release(b)   # the primary (creator) pin
                self.store.delete(b)
                freed += size
                with self._lock:
                    self.spill_stats["objects"] += 1
                    self.spill_stats["bytes"] += size
            with self._lock:
                self.spill_stats["seconds"] += time.perf_counter() - t0
            return freed

    def _h_spill_request(self, msg, frames):
        """A producer on this node could not fit `bytes` into the store
        this owner maps: spill this owner's primaries there to make room
        (reference: plasma's create queue waits on the raylet's spilling,
        local_object_manager.h:41). Another node's store: nothing to do."""
        if self.store is None or msg.get("store_name") != self.store.name:
            return {"freed": 0}
        return {"freed": self._spill_primaries(int(msg["bytes"]))}

    def get(self, refs: list[ObjectRef], timeout=None):
        self.flush_submits()  # about to block: no batch may sit buffered
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(r, deadline) for r in refs]

    def _remaining(self, deadline):
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise exc.GetTimeoutError("get() timed out")
        return rem

    def _get_one(self, ref: ObjectRef, deadline):
        b = ref.id.binary()
        with self._lock:
            st = self._owned.get(b)
        if st is not None:
            while True:
                if not st.event.wait(self._remaining(deadline)):
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {ref}")
                # consumer progress: the value (or error) is being
                # delivered — this ref is no longer a stranded candidate
                st.consumed = True
                if st.error is not None:
                    self._raise_stored(st.error)
                if st.has_cached:
                    return st.value_cached
                if st.spilled_path is not None:
                    # disk tier: read back without evicting anything else
                    try:
                        with open(st.spilled_path, "rb") as f:
                            data = f.read()
                    except OSError as e:
                        raise exc.ObjectLostError(
                            f"spilled object {ref} lost: {e}") from e
                    value = ser.deserialize(memoryview(data))
                    st.value_cached = value
                    st.has_cached = True
                    return value
                try:
                    value = self._materialize(b, st.inline, st.location,
                                              st.store_name)
                except exc.ObjectLostError:
                    # lineage reconstruction: re-execute the producing
                    # task (reference: ObjectRecoveryManager,
                    # core_worker/object_recovery_manager.h:38)
                    if not self._try_reconstruct(st):
                        raise
                    continue
                st.value_cached = value
                st.has_cached = True
                return value
        # borrowed: ask the owner
        owner = ref.owner
        if owner is None or owner == self.address:
            raise exc.ObjectLostError(f"no owner known for {ref}")
        # new borrow LIFECYCLE: take a GLOBALLY monotonic epoch — any
        # release still queued from a previous lifecycle of this oid
        # carries a smaller epoch and the owner ignores it after this
        # registration (no queue purging: the queued release must still
        # go out to clear the OLD registration if this resolve fails)
        with self._lock:
            self._borrow_epoch_counter += 1
            epoch = self._borrow_epoch_counter
        lost_at = None  # location we failed to materialize from
        lost_attempts = 0
        while True:
            t = self._remaining(deadline)
            try:
                value, frames = self.client.call_frames(
                    owner, "resolve",
                    {"oid": b, "wait": True, "borrower": self.address,
                     "epoch": epoch, "lost_at": lost_at},
                    timeout=min(t, 5.0) if t is not None else 5.0)
                lost_at = None
            except PeerUnavailableError as e:
                if "timed out" in str(e):
                    continue  # owner alive but object pending; keep waiting
                raise exc.OwnerDiedError(
                    f"owner {owner} of {ref} is unreachable") from e
            status = value["status"]
            if status == "pending":
                continue
            if status == "error":
                raise ser.loads_msg(frames[0])
            if status == "inline":
                return ser.deserialize(memoryview(frames[0]))
            if status == "location":
                # the owner registered us as a borrower atomically while
                # serving this resolve (no free window between reply and
                # registration); remember who to release to + the epoch
                # this lifecycle registered under
                with self._lock:
                    self._borrowed_owner[b] = owner
                    self._borrow_epoch[b] = epoch
                try:
                    return self._materialize(b, None, value["location"],
                                             value.get("store_name"))
                except exc.ObjectLostError:
                    # the handed-out location is gone (node died between
                    # task completion and this fetch). Report it to the
                    # owner on the next resolve so the OWNER runs lineage
                    # reconstruction (reference: ObjectRecoveryManager,
                    # object_recovery_manager.h:38 — recovery is always
                    # owner-driven); we then wait like any pending get.
                    lost_attempts += 1
                    if lost_attempts > 3:
                        raise
                    lost_at = value["location"]
                    continue
            raise exc.ObjectLostError(f"{ref}: owner reports {status}")

    def _try_reconstruct(self, st: "_Owned") -> bool:
        """Resubmit the task whose output was lost (its spec is the
        lineage). Consumes the task's retry budget; `put()` objects have
        no lineage and are not recoverable — same as the reference.

        Lost ARGS are reconstructed FIRST and the task is only submitted
        once they exist again (reference: ObjectRecoveryManager walks
        the lineage, object_recovery_manager.h:38). Dispatching a
        consumer whose args are still lost would park a worker slot on
        the arg fetch — a chain deeper than the node's worker cap then
        deadlocks the pool."""
        spec = st.spec
        if spec is None or not self.nodelet_address:
            return False
        with self._lock:
            states = [self._owned.get(b) for b in spec.return_oids]
            st0 = states[0] if states else None
            if st0 is None or st0.cancelled:
                return False
            if not st0.event.is_set():
                # another getter already kicked off reconstruction of
                # this task: just go back to waiting on the event
                return True
            if st0.retries_left <= 0:
                return False
            for s in states:
                if s is None:
                    continue
                s.retries_left -= 1
                s.event.clear()
                s.inline = None
                s.location = None
                s.store_name = None
                s.value_cached = None
                s.has_cached = False
            spec.attempt += 1
            spec.spillback_count = 0

        lost_args = self._reconstruct_lost_args(spec)

        def submit():
            for ast in lost_args:
                if not ast.event.wait(timeout=120) or ast.error is not None:
                    for s in states:
                        if s is not None and not s.event.is_set():
                            s.error = exc.ObjectLostError(
                                "argument reconstruction failed")
                            s.event.set()
                    return
            try:
                self.client.call(self.nodelet_address, "schedule_task",
                                 {"spec": dataclass_dict(spec)}, timeout=30,
                                 retries=2)
            except Exception:  # noqa: BLE001
                for s in states:
                    if s is not None and not s.event.is_set():
                        s.error = exc.ObjectLostError(
                            "reconstruction submission failed")
                        s.event.set()

        if lost_args:
            # park the wait off this getter thread; the submit fires the
            # moment the last argument is rebuilt
            threading.Thread(target=submit, daemon=True,
                             name="reconstruct-args").start()
        else:
            submit()
        return True

    def _reconstruct_lost_args(self, spec: TaskSpec) -> list:
        """Probe this task's ref args that WE own; kick reconstruction
        for any whose bytes are gone. Returns the _Owned states to wait
        on before (re)submitting the task."""
        waits = []
        for a in list(spec.args) + list(spec.kwargs.values()):
            if not isinstance(a, RefArg) or a.owner != self.address:
                continue
            with self._lock:
                ast = self._owned.get(a.oid)
            if ast is None:
                continue
            if not ast.event.is_set():
                waits.append(ast)  # already being rebuilt elsewhere
                continue
            if ast.error is not None or ast.inline is not None or \
                    ast.spilled_path is not None:
                continue  # error propagates / bytes are not on any node
            loc = (self.nodelet_address if ast.location == "local"
                   else ast.location)
            if loc is None:
                continue
            alive = True
            if loc != self.nodelet_address:
                try:
                    meta = self.client.call(loc, "object_meta",
                                            {"oid": a.oid}, timeout=3)
                    alive = bool(meta.get("ok"))
                except Exception:  # noqa: BLE001
                    alive = False
            else:
                alive = self.store is not None and self.store.contains(a.oid)
            if not alive and self._try_reconstruct(ast):
                waits.append(ast)
        return waits

    def _materialize(self, oid: bytes, inline, location, store_name):
        if inline is not None:
            return ser.deserialize(memoryview(inline))
        if self.store is not None and self.store.contains(oid):
            return self._pinned_deserialize(oid)
        if location in (None, "local"):
            raise exc.ObjectLostError(f"object {oid.hex()[:12]} lost from store")
        # pull through local nodelet into local store, then read zero-copy
        if self.nodelet_address and self.store is not None:
            try:
                r = self.client.call(self.nodelet_address, "fetch_object",
                                     {"oid": oid, "location": location},
                                     timeout=90)
                if r.get("ok") and self.store.contains(oid):
                    return self._pinned_deserialize(oid)
            except Exception:  # noqa: BLE001
                r = {}  # holder node unreachable: fall through
            if r.get("holder_dead"):
                raise exc.ObjectLostError(
                    f"object {oid.hex()[:12]}: holder {location} is dead")
        # last resort: direct pull into memory. Probe liveness first so
        # a dead holder fails fast, while a live holder gets the full
        # window for a big single-frame transfer.
        try:
            self.client.call(location, "ping", {}, timeout=5, retries=1)
        except Exception as e:  # noqa: BLE001
            raise exc.ObjectLostError(
                f"object {oid.hex()[:12]}: holder {location} unreachable "
                f"({e})") from e
        try:
            value, frames = self.client.call_frames(location, "pull_object",
                                                    {"oid": oid}, timeout=120)
        except Exception as e:  # noqa: BLE001
            raise exc.ObjectLostError(
                f"object {oid.hex()[:12]}: pull from {location} failed "
                f"({e})") from e
        if not value.get("ok"):
            raise exc.ObjectLostError(f"object {oid.hex()[:12]}: "
                                      f"{value.get('error')}")
        return ser.deserialize(memoryview(frames[0]))

    def _pinned_deserialize(self, oid: bytes):
        """Read an object zero-copy out of the local store. If the
        deserialized graph references out-of-band buffers (numpy/jax
        arrays aliasing store memory), keep the store refcount held so
        the region cannot be evicted or reused under the value."""
        view = self.store.get(oid)
        if view is None:
            raise exc.ObjectLostError(f"object {oid.hex()[:12]} vanished")
        hold = _StoreHold(self.store, oid)  # takes over get's refcount
        value, n_oob = ser.deserialize_info(view, hold)
        if n_oob:
            # the ref holds the bytes too, so spilling leaves them be
            with self._lock:
                self._pins.setdefault(oid, hold)
        return value

    def _release_pin(self, oid: bytes):
        with self._lock:
            hold = self._pins.pop(oid, None)
        del hold  # the store is released once no value aliases the bytes

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        self.flush_submits()
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready = []
        while True:
            still = []
            for r in pending:
                if self._is_ready(r):
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        return ready, pending

    def _is_ready(self, ref: ObjectRef) -> bool:
        b = ref.id.binary()
        with self._lock:
            st = self._owned.get(b)
        if st is not None:
            return st.event.is_set()
        try:
            value = self.client.call(ref.owner, "resolve",
                                     {"oid": b, "wait": False}, timeout=5)
            return value["status"] != "pending"
        except Exception:
            return False

    def as_future(self, ref: ObjectRef):
        import concurrent.futures as cf

        self.flush_submits()
        fut = cf.Future()

        def waiter():
            try:
                fut.set_result(self._get_one(ref, None))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=waiter, daemon=True).start()
        return fut

    # -- owner-side handlers --------------------------------------------------

    def _h_metrics_text(self, msg, frames):
        raise NotImplementedError(
            "the metrics plane (metrics_text) is not ported to "
            "ray_tpu_torch yet")

    def _h_profile_capture(self, msg, frames):
        raise NotImplementedError(
            "the profiler (profile_capture) is not ported to "
            "ray_tpu_torch yet")

    def _cpu_account(self, label: str, kind: str, cpu_s: float) -> None:
        """Attribute one execution's thread CPU time: the
        core_task_cpu_seconds_total{kind} counter plus a bounded
        per-label table ((task name / ActorClass.method) -> cumulative
        CPU + call count) served by the cpu_stats RPC."""
        _task_cpu_observe(kind, cpu_s)
        with self._cpu_lock:
            ent = self._cpu_by_label.get((label, kind))
            if ent is None:
                if len(self._cpu_by_label) >= 512:
                    # label-cardinality bound: the tail folds into one
                    # bucket instead of growing without limit
                    ent = self._cpu_by_label.setdefault(
                        ("_other", kind), [0.0, 0])
                else:
                    ent = self._cpu_by_label[(label, kind)] = [0.0, 0]
            ent[0] += max(0.0, cpu_s)
            ent[1] += 1

    def _h_cpu_stats(self, msg, frames):
        """This process's per-task/actor-method CPU attribution table
        (empty on drivers — only exec loops feed it)."""
        with self._cpu_lock:
            rows = [{"label": label, "kind": kind,
                     "cpu_seconds": ent[0], "calls": ent[1]}
                    for (label, kind), ent in self._cpu_by_label.items()]
        return {"rows": rows}

    def audit_stranded(self, age_threshold_s: float | None = None
                       ) -> list[dict]:
        """The stranded-ref auditor: owned refs that are READY, older
        than the age threshold, and show no consumer progress — never
        locally get()-consumed, never served to a borrower, with no
        live borrower registration. These are the leak shape the PR-11
        traceback pin produced (refs held alive by accident, that
        nothing will ever read); `object_store_stranded_bytes` and the
        watchtower `object-stranded-refs` rule surface the aggregate,
        this list names the owners/creators."""
        if age_threshold_s is None:
            age_threshold_s = _stranded_age_s()
        now = time.monotonic()
        out = []
        with self._lock:
            for b, st in self._owned.items():
                age = now - st.created_at
                if not is_stranded(st.event.is_set(), st.consumed,
                                   len(st.borrowers), age,
                                   age_threshold_s):
                    continue
                out.append({"object_id": b.hex(), "label": st.label,
                            "size": st.size, "age_s": round(age, 3),
                            "error": st.error is not None,
                            "owner": self.address})
        return out

    def _h_list_objects(self, msg, frames):
        """Owner-side object table for the state API (reference:
        `ray list objects` / `ray memory` aggregate core-worker object
        tables, python/ray/util/state/api.py:1)."""
        out = []
        now = time.monotonic()
        with self._lock:
            for b, st in self._owned.items():
                out.append({
                    "object_id": b.hex(),
                    "size": st.size,
                    "ready": st.event.is_set(),
                    "error": st.error is not None,
                    "inline": st.inline is not None,
                    "location": (self.nodelet_address
                                 if st.location == "local" else st.location),
                    "spilled": st.spilled_path is not None,
                    "borrowers": len(st.borrowers),
                    "reconstructable": (st.spec is not None
                                        and st.retries_left > 0),
                    "owner": self.address,
                    "label": st.label,
                    "age_s": round(now - st.created_at, 3),
                    "consumed": st.consumed,
                })
        return {"objects": out}

    def _h_resolve(self, msg, frames):
        b = msg["oid"]
        with self._lock:
            st = self._owned.get(b)
        if st is None:
            return {"status": "unknown"}
        lost_at = msg.get("lost_at")
        if lost_at is not None:
            # a borrower failed to materialize from the location we handed
            # out: if we'd still hand out that same location, the bytes are
            # gone — kick owner-driven lineage reconstruction (clears the
            # event; this resolve then parks in the pending path below)
            with self._lock:
                loc = (self.nodelet_address if st.location == "local"
                       else st.location)
                stale = (st.event.is_set() and st.error is None and
                         st.inline is None and st.spilled_path is None and
                         loc == lost_at)
            if stale and not self._try_reconstruct(st):
                return {"status": "error"}, [ser.dumps_msg(
                    exc.ObjectLostError(
                        f"object {b.hex()[:12]} lost at {lost_at} and not "
                        f"reconstructable"))]
        if msg.get("wait", True):
            st.event.wait(timeout=4.5)
        if not st.event.is_set():
            return {"status": "pending"}
        # serving a borrower IS consumer progress (the stranded auditor
        # must not flag refs a remote consumer is actively reading)
        st.consumed = True
        if st.error is not None:
            return {"status": "error"}, [ser.dumps_msg(st.error)]
        if st.inline is not None:
            return {"status": "inline"}, [st.inline]
        if st.spilled_path is not None:
            # disk tier: serve the bytes directly from the spill file
            # (reference: spilled objects are restored/served via their
            # spilled URL, local_object_manager.h:41). Serving inline
            # avoids a restore storm re-pressuring the store that forced
            # the spill in the first place; no borrow registration needed
            # since the reply carries the full payload.
            try:
                with open(st.spilled_path, "rb") as f:
                    return {"status": "inline"}, [f.read()]
            except OSError:
                # racing un-spill/free: fall through to the live state
                pass
        borrower = msg.get("borrower")
        if borrower:
            # register atomically with the location handout: the bytes
            # stay pinned until this borrower sends borrow_release. The
            # spiller commits under this same lock and skips objects with
            # borrowers, so this cannot race a concurrent spill.
            with self._lock:
                if self._owned.get(msg["oid"]) is not st:
                    return {"status": "unknown"}  # freed while we waited
                if st.spilled_path is not None:
                    try:
                        # justified GL012: the spilled read must stay
                        # atomic with the ownership re-check above — a
                        # concurrent free/un-spill outside the lock
                        # could unlink the file between check and read.
                        # v2 index audit: this open() is the ONLY
                        # blocking effect in _h_resolve's closure under
                        # self._lock — no callee under the lock blocks
                        # transitively, so the critical section is
                        # exactly one local file read
                        # graftlint: disable=blocking-under-lock
                        with open(st.spilled_path, "rb") as f:
                            return {"status": "inline"}, [f.read()]
                    except OSError:
                        return {"status": "unknown"}
                st.borrowers[borrower] = int(msg.get("epoch", 0))
        if st.location == "local":
            # owner-local store: hand out bytes directly (borrower may be
            # anywhere; its nodelet pulls from our nodelet)
            return {"status": "location", "location": self.nodelet_address,
                    "store_name": self.store_name_of(st)}
        return {"status": "location", "location": st.location,
                "store_name": st.store_name}

    def store_name_of(self, st):
        return self.store.name if self.store is not None else st.store_name

    def _h_borrow_release(self, msg, frames):
        b = msg["oid"]
        with self._lock:
            st = self._owned.get(b)
            if st is None:
                return
            addr = msg["borrower"]
            reg = st.borrowers.get(addr)
            if reg is not None and reg <= int(msg.get("epoch", 1 << 62)):
                st.borrowers.pop(addr, None)
            if st.borrowers or self._refcounts.get(b, 0) > 0 or \
                    not st.event.is_set():
                return
            self._owned.pop(b, None)
        self._release_pin(b)
        self._free_remote_bytes(st, b)

    def _h_task_done(self, msg, frames):
        oids = msg["oids"]
        task_id = msg.get("task_id") or b""
        if task_id:
            with self._lock:
                ab = self._task_actor.pop(task_id, None)
                if ab is not None:
                    pend = self._inflight_actor.get(ab)
                    if pend is not None:
                        pend.pop(task_id, None)
                ent = self._task_lease.pop(task_id, None)
                if ent is not None:
                    ent[0].inflight.discard(task_id)
                    ent[0].last_active = time.monotonic()
        else:
            ent = None
        if ent is not None:
            self._refill_lease(ent[0])
        err_blob = msg.get("error")
        if err_blob is not None:
            try:
                error = ser.loads_msg(err_blob)
            except Exception:  # noqa: BLE001
                error = exc.TaskError(RuntimeError("undecodable remote error"))
            retryable = msg.get("retryable", False)
            retried = self._task_failed(oids, error, retryable)
            if not retried and task_id:
                self._unpin_task_args(task_id)
                self._stream_fail(task_id, error)
            return
        if task_id:
            self._unpin_task_args(task_id)
        locations = msg.get("locations", [])
        for i, b in enumerate(oids):
            with self._lock:
                st = self._owned.get(b)
            if st is None:
                continue
            loc = locations[i] if i < len(locations) else None
            if loc is None:
                st.inline = frames[i] if i < len(frames) else None
                st.size = len(st.inline or b"")
            else:
                st.location = loc["address"]
                st.store_name = loc.get("store_name")
                st.size = loc.get("size", 0)
            st.event.set()

    def _h_task_done_batch(self, msg, frames):
        """N task_done messages from one worker in one frame (the
        return-path half of the submit coalescer). Frames arrive
        concatenated in entry order; counts[i] slices them back out."""
        off = 0
        for ent, n in zip(msg["entries"], msg["counts"]):
            self._h_task_done(ent, frames[off:off + n])
            off += n

    def _task_failed(self, oids, error, retryable) -> bool:
        spec = None
        with self._lock:
            for b in oids:
                st = self._owned.get(b)
                if st is not None and st.spec is not None:
                    spec = st.spec
                    break
            # first-writer-wins: a late failure report (e.g. the nodelet
            # reaping a worker that already delivered its result directly)
            # must neither re-execute nor clobber a completed task
            done = [b for b in oids
                    if (s := self._owned.get(b)) is not None
                    and s.event.is_set()]
            if done:
                return True  # treat as handled; results already delivered
        if spec is not None and retryable:
            with self._lock:
                st0 = self._owned.get(spec.return_oids[0])
                can_retry = st0 is not None and st0.retries_left > 0 and \
                    not st0.cancelled
                if can_retry:
                    for b in spec.return_oids:
                        s = self._owned.get(b)
                        if s is not None:
                            s.retries_left -= 1
            if can_retry:
                try:
                    spec.attempt += 1
                    spec.spillback_count = 0
                    self._ledger_event(
                        spec.task_id, spec.name, "RETRIED",
                        trace=spec.trace,
                        detail=f"attempt {spec.attempt}")
                    self.client.call(self.nodelet_address, "schedule_task",
                                     {"spec": dataclass_dict(spec)}, timeout=30,
                                     retries=2)
                    return True
                except Exception:
                    pass
        for b in oids:
            with self._lock:
                st = self._owned.get(b)
            if st is not None and not st.event.is_set():
                st.error = error
                st.event.set()
        if spec is not None:
            self._stream_fail(spec.task_id, error)
        return False

    def _h_pubsub(self, msg, frames):
        if msg.get("topic") == "actor":
            data = msg["data"]
            aid = bytes.fromhex(data["actor_id"])
            with self._lock:
                if data["event"] in ("dead", "restarting"):
                    self._actor_addr.pop(aid, None)
                elif data["event"] == "ready":
                    self._actor_addr[aid] = data["address"]
            if data["event"] in ("dead", "restarting"):
                # calls in flight on the lost incarnation will never get a
                # task_done: fail them now (at-most-once semantics)
                with self._lock:
                    pend = self._inflight_actor.pop(aid, {})
                    for tid in pend:
                        self._task_actor.pop(tid, None)
                cause = data.get("cause", "actor died")
                for tid, oids in pend.items():
                    err = exc.ActorDiedError(
                        f"actor died with call in flight: {cause}")
                    self._error_oids(oids, err)
                    self._stream_fail(tid, err)
                    self._unpin_task_args(tid)
            if data["event"] == "dead":
                self._unpin_task_args(aid)

    # ------------------------------------------------------------ streams
    # Owner side of num_returns="streaming" (reference: ObjectRefStream +
    # stream bookkeeping in the TaskManager, core_worker/task_manager.h:
    # 104,212). Items are real owned objects (inline bytes or a store
    # location) registered as they arrive, so borrowers resolve them via
    # the ordinary ownership protocol; the stream adds only the index →
    # oid order book, end/error markers, and consumer progress for
    # producer backpressure.

    def stream_next(self, task_id: bytes, owner: str, index: int,
                    timeout: float | None = None):
        """Block until item `index` of the stream exists; return its
        ObjectRef. Raises StopIteration at end-of-stream, the producer's
        error past the last yielded item, or GetTimeoutError."""
        self.flush_submits()
        deadline = None if timeout is None else time.monotonic() + timeout
        if owner == self.address:
            return self._stream_next_local(task_id, index, deadline)
        while True:
            t = self._remaining(deadline)  # raises GetTimeoutError
            try:
                value, frames = self.client.call_frames(
                    owner, "stream_next", {"task_id": task_id, "index": index},
                    timeout=min(t, 6.0) if t is not None else 6.0)
            except PeerUnavailableError as e:
                if "timed out" in str(e):
                    continue
                raise exc.OwnerDiedError(
                    f"stream owner {owner} unreachable") from e
            status = value["status"]
            if status == "pending":
                continue
            if status == "end":
                raise StopIteration
            if status == "error":
                raise ser.loads_msg(frames[0])
            if status == "ready":
                oid = value["oid"]
                if value.get("inline"):
                    # small item: ownership TRANSFERRED with the payload
                    # (the owner popped its copy) — register it as ours
                    st = _Owned()
                    st.inline = bytes(frames[0])
                    st.size = len(st.inline)
                    st.event.set()
                    with self._lock:
                        self._owned[oid] = st
                    return ObjectRef(ObjectID(oid), owner=self.address)
                return ObjectRef(ObjectID(oid), owner=owner)
            raise exc.ObjectLostError(
                f"stream item {index} lost ({status}) — streams are "
                f"single-consumer")

    def _stream_next_local(self, task_id: bytes, index: int, deadline):
        with self._lock:
            stream = self._streams.get(task_id)
        if stream is None:
            raise StopIteration  # closed or fully consumed earlier
        ended = False
        with stream.cond:
            while True:
                if index in stream.items:
                    oid = stream.items[index]
                    stream.consumed = max(stream.consumed, index + 1)
                    stream.cond.notify_all()
                    break
                if stream.end is not None and index >= stream.end:
                    ended = True
                    break
                if stream.error is not None:
                    self._raise_stored(stream.error)
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    raise exc.GetTimeoutError("stream_next timed out")
                stream.cond.wait(min(rem, 1.0) if rem is not None else 1.0)
        if ended:
            self._stream_pop(task_id, stream)
            raise StopIteration
        return ObjectRef(ObjectID(oid), owner=self.address)

    def _stream_pop(self, task_id: bytes, stream: _StreamState):
        """Exhausted: drop the order book and the (ref-less) sentinel."""
        with self._lock:
            self._streams.pop(task_id, None)
            sent = self._owned.get(stream.sentinel)
            if sent is not None and self._refcounts.get(stream.sentinel,
                                                        0) == 0:
                self._owned.pop(stream.sentinel, None)

    def _h_stream_item(self, msg, frames):
        task_id, index, oid = msg["task_id"], msg["index"], msg["oid"]
        loc = msg.get("location")
        with self._lock:
            stream = self._streams.get(task_id)
            if stream is not None:
                st = self._owned.get(oid)
                if st is None:
                    st = _Owned()
                    self._owned[oid] = st
                # retry replay HEALS a dead location: the re-executed
                # producer may live on a different node, and the item oid
                # is deterministic in (task_id, index)
                if loc is None:
                    st.inline = bytes(frames[0])
                    st.size = len(st.inline)
                    st.location = None
                    st.store_name = None
                else:
                    st.inline = None
                    st.location = loc["address"]
                    st.store_name = loc.get("store_name")
                    st.size = loc.get("size", 0)
                st.event.set()
        orphan = stream is None
        if stream is not None:
            with stream.cond:
                if stream.closed:
                    # lost the race with _h_stream_close: its free sweep
                    # ran off `items` before this index landed — undo the
                    # registration and free the bytes ourselves
                    orphan = True
                else:
                    stream.items[index] = oid
                    if msg.get("producer"):
                        stream.producer = msg["producer"]
                    stream.cond.notify_all()
        if orphan:
            with self._lock:
                st = self._owned.get(oid)
                if st is not None and self._refcounts.get(oid, 0) == 0 \
                        and not st.borrowers:
                    self._owned.pop(oid, None)
            if loc is not None:
                try:
                    self.client.send_oneway(loc["address"], "free_object",
                                            {"oid": oid})
                except Exception:  # noqa: BLE001
                    pass

    def _h_stream_end(self, msg, frames):
        with self._lock:
            stream = self._streams.get(msg["task_id"])
        if stream is None:
            return
        with stream.cond:
            if stream.error is None and stream.end is None:
                stream.end = int(msg["count"])
            if msg.get("producer"):
                stream.producer = msg["producer"]
            stream.cond.notify_all()

    def _h_stream_next(self, msg, frames):
        """Remote-consumer next (borrower iterating a pickled generator).
        Long-polls ~4.5s then reports pending, like resolve."""
        task_id, index = msg["task_id"], msg["index"]
        with self._lock:
            stream = self._streams.get(task_id)
        if stream is None:
            return {"status": "end"}
        # the request for index N is the delivery ACK for index N-1:
        # retire OUR copy of the previous inline item only now, so a
        # reply lost in transit is recoverable by re-asking the same
        # index (popping at handout would make a client-side timeout
        # permanently lose a produced item)
        if index > 0:
            with stream.cond:
                prev = stream.items.get(index - 1)
            if prev is not None:
                with self._lock:
                    st = self._owned.get(prev)
                    if st is not None and st.inline is not None and \
                            self._refcounts.get(prev, 0) == 0 and \
                            not st.borrowers:
                        self._owned.pop(prev, None)
        oid = None
        ended = False
        err = None
        with stream.cond:
            deadline = time.monotonic() + 4.5
            while True:
                if index in stream.items:
                    oid = stream.items[index]
                    stream.consumed = max(stream.consumed, index + 1)
                    stream.cond.notify_all()
                    break
                if stream.end is not None and index >= stream.end:
                    ended = True
                    break
                if stream.error is not None:
                    err = stream.error
                    break
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return {"status": "pending"}
                stream.cond.wait(rem)
        if ended:
            self._stream_pop(task_id, stream)
            return {"status": "end"}
        if err is not None:
            return {"status": "error"}, [ser.dumps_msg(err)]
        with self._lock:
            st = self._owned.get(oid)
            if st is not None and st.inline is not None:
                # serve inline payload WITH the ref; the consumer caches
                # it as its own copy, and our entry retires on the next
                # index's ack (above) / stream close
                return ({"status": "ready", "oid": oid, "inline": True},
                        [st.inline])
        if st is None:
            return {"status": "lost"}
        return {"status": "ready", "oid": oid, "inline": False}

    def _h_stream_state(self, msg, frames):
        """Producer backpressure poll: consumer progress + liveness."""
        with self._lock:
            stream = self._streams.get(msg["task_id"])
        if stream is None:
            return {"consumed": 1 << 60, "closed": True}
        with stream.cond:
            return {"consumed": stream.consumed, "closed": stream.closed}

    def stream_close(self, task_id: bytes, owner: str):
        """Consumer dropped the generator early. May run from __del__ at
        an arbitrary gc point: only QUEUE the oneway (even to ourselves);
        the submit sweeper flushes it (same rule as borrow_release)."""
        with self._lock:
            self._deferred_sends.append(
                (owner, "stream_close", {"task_id": task_id}))

    def _h_stream_close(self, msg, frames):
        task_id = msg["task_id"]
        with self._lock:
            stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        with stream.cond:
            stream.closed = True
            items = list(stream.items.items())
            consumed = stream.consumed
            producer = stream.producer
            stream.cond.notify_all()
        freed = []
        with self._lock:
            for i, oid in items:
                if self._refcounts.get(oid, 0) > 0:
                    continue
                st = self._owned.get(oid)
                if st is None or st.borrowers:
                    continue
                # free unconsumed items outright; consumed INLINE items
                # were served with their payload (the remote consumer
                # holds its own copy), so retire those too — consumed
                # LOCATED items may still be fetched by a live borrower
                # ref, keep them for the borrow protocol to release
                if i >= consumed or st.inline is not None:
                    self._owned.pop(oid, None)
                    if i >= consumed:
                        freed.append((oid, st))
            # the sentinel never has a user-visible ObjectRef: drop it
            # unconditionally (event may not be set yet if the producer
            # is still being cancelled — a late task_done just no-ops)
            if self._refcounts.get(stream.sentinel, 0) == 0:
                self._owned.pop(stream.sentinel, None)
        for oid, st in freed:
            self._release_pin(oid)
            self._free_remote_bytes(st, oid)
        if producer:
            try:
                self.client.send_oneway(producer, "stream_cancel",
                                        {"task_id": task_id})
            except Exception:  # noqa: BLE001
                pass

    def _stream_fail(self, task_id: bytes, error: BaseException):
        """Producer died / task exhausted retries: wake the consumer with
        the error past the last delivered item."""
        with self._lock:
            stream = self._streams.get(task_id)
        if stream is None:
            return
        with stream.cond:
            if stream.end is None and stream.error is None:
                stream.error = error
            stream.cond.notify_all()

    # ------------------------------------------------------------ tasks

    def _export_fn(self, fn) -> str:
        # identity-level cache: repeated submits of the same function
        # object must not re-pickle it every call (hot-path cost)
        try:
            fn_id = self._fn_id_cache.get(fn)
        except TypeError:  # non-weakrefable callable (e.g. np.ufunc)
            fn_id = None
        if fn_id is not None:
            return fn_id
        blob = ser.dumps_fn(fn)
        fn_id = hashlib.sha1(blob).hexdigest()
        with self._lock:
            exported = fn_id in self._exported_fns
        if not exported:
            # off-lock RPC; a racing duplicate kv_put is idempotent
            # (overwrite=False, content-addressed key)
            self.client.call(self.head_address, "kv_put",
                             {"ns": "fn", "key": fn_id, "overwrite": False},
                             frames=[blob], timeout=30, retries=2)
            with self._lock:
                self._exported_fns.add(fn_id)
                self._fn_cache[fn_id] = fn
        try:
            self._fn_id_cache[fn] = fn_id
        except TypeError:
            pass  # unhashable callable
        return fn_id

    def _fetch_fn(self, fn_id: str) -> Callable:
        with self._lock:
            fn = self._fn_cache.get(fn_id)
        if fn is None:
            value, frames = self.client.call_frames(
                self.head_address, "kv_get", {"ns": "fn", "key": fn_id},
                timeout=30, retries=2)
            if not value.get("found"):
                raise exc.RayTpuError(f"function {fn_id} not found in KV")
            fn = ser.loads_fn(frames[0])
            with self._lock:
                # keep the first deserialization a racing fetch cached
                fn = self._fn_cache.setdefault(fn_id, fn)
        return fn

    def _encode_args(self, args, kwargs):
        ref_oids: list[bytes] = []

        def enc(v):
            if isinstance(v, ObjectRef):
                ref_oids.append(v.id.binary())
                return RefArg(v.id.binary(), v.owner or self.address)
            return v

        eargs = tuple(enc(a) for a in args)
        ekwargs = {k: enc(v) for k, v in kwargs.items()}
        return eargs, ekwargs, ref_oids

    def _pin_task_args(self, task_id: bytes, ref_oids: list[bytes]):
        if not ref_oids:
            return
        for b in ref_oids:
            self._incref(b)
        with self._lock:
            self._task_arg_refs[task_id] = ref_oids

    def _unpin_task_args(self, task_id: bytes):
        with self._lock:
            oids = self._task_arg_refs.pop(task_id, None)
        for b in oids or ():
            self._decref(b)

    def _normalized_runtime_env(self, runtime_env):
        key = None
        if runtime_env:
            # the cache key must track working_dir CONTENT (mtime/size
            # fingerprint), or edits between submits ship stale code
            fp = ""
            wd = runtime_env.get("working_dir")
            if wd:
                fp = rtenv.dir_fingerprint(wd)
            key = ("rtenv", json_stable(runtime_env), fp)
            with self._lock:
                cached = self._rtenv_cache.get(key)
            if cached is not None:
                return cached
        norm = rtenv.normalize(runtime_env, self.client, self.head_address)
        if key is not None:
            with self._lock:
                if len(self._rtenv_cache) > 64:
                    self._rtenv_cache.clear()
                self._rtenv_cache[key] = norm
        return norm

    def submit_task(self, fn, args, kwargs, opts: TaskOptions):
        t_submit0 = time.monotonic_ns()
        streaming = opts.num_returns in ("streaming", "dynamic")
        # a streaming task has ONE sentinel return oid: it completes with
        # the item count when the generator is exhausted, and carries the
        # spec so the whole retry pipeline applies to the stream unchanged
        n = 1 if streaming else opts.num_returns
        oids = [ObjectID.random() for _ in range(n)]
        fn_id = self._export_fn(fn)
        eargs, ekwargs, ref_oids = self._encode_args(args, kwargs)
        pg = opts.placement_group
        pg_id = pg.id.binary() if pg is not None else None
        spec = TaskSpec(
            task_id=TaskID.random().binary(),
            name=opts.name or getattr(fn, "__name__", "task"),
            fn_id=fn_id,
            args=eargs,
            kwargs=ekwargs,
            return_oids=[o.binary() for o in oids],
            owner=self.address,
            resources=opts.resource_request(),
            max_retries=opts.max_retries,
            retry_exceptions=opts.retry_exceptions,
            placement_group=pg_id,
            bundle_index=opts.placement_group_bundle_index,
            label_selector=opts.label_selector,
            runtime_env=self._normalized_runtime_env(opts.runtime_env),
            trace=_child_trace(self._ctx.trace),
            streaming=streaming,
            backpressure=int(opts.generator_backpressure_num_objects or 0),
        )
        with self._lock:
            for o in oids:
                self._owned[o.binary()] = _Owned(spec=spec,
                                                retries_left=opts.max_retries)
            if streaming:
                self._streams[spec.task_id] = _StreamState(oids[0].binary())
        self._pin_task_args(spec.task_id, ref_oids)
        # ledger SUBMITTED: the first transition of the task state
        # machine, stamped at the owner before any routing decision
        self._ledger_event(spec.task_id, spec.name, "SUBMITTED",
                           trace=spec.trace)
        # arg locality: prefer the node already holding the largest args
        # (reference: LocalityAwareLeasePolicy, core_worker/lease_policy.h:58)
        locality = (None if pg_id is not None
                    else self._locality_target(ref_oids))
        # hot path: repeated same-shape tasks ride a reused worker lease
        # (direct pipelined push — no per-task scheduling hop; reference:
        # normal_task_submitter.cc:137 OnWorkerIdle)
        leased = (pg_id is None and not opts.label_selector
                  and locality is None
                  and self.nodelet_address is not None
                  and self._submit_via_lease(spec))
        if not leased:
            target = locality or self.nodelet_address
            if pg_id is not None:
                target = self._pg_node_address(
                    pg_id, opts.placement_group_bundle_index,
                    spec.resources) or target
            if target != self.nodelet_address:
                self._prefetch_args(target, spec)
            if locality is not None and pg_id is None:
                # the locality node may have died since the arg's location
                # was recorded (the ownership table is not a liveness
                # oracle). On timeout, resubmitting ELSEWHERE is only safe
                # if the node is actually gone — schedule_task dedup is
                # per-nodelet, so a slow-but-delivered original on a LIVE
                # node would otherwise run twice. Probe with ping: alive ⇒
                # retry the SAME node (its dedup absorbs duplicates);
                # dead ⇒ it cannot run the task, local resubmit is safe.
                try:
                    self.client.call(target, "schedule_task",
                                     {"spec": dataclass_dict(spec)},
                                     timeout=10)
                except PeerUnavailableError:
                    alive = False
                    try:
                        self.client.call(target, "ping", {}, timeout=5)
                        alive = True
                    except Exception:  # noqa: BLE001
                        pass
                    retry_target = (target if alive
                                    else self.nodelet_address)
                    self.client.call(retry_target, "schedule_task",
                                     {"spec": dataclass_dict(spec)},
                                     timeout=60, retries=2)
            else:
                # plain/pg/label tasks ride the submit coalescer: N
                # specs to the same nodelet pack into one
                # schedule_tasks frame (was: one SYNCHRONOUS
                # schedule_task round trip per task); delivery errors
                # surface on the returned refs via the ack sweeper
                self._submit_batcher.append(("schedule_tasks", target),
                                            spec)
        # the submit span makes the DRIVER visible on the merged timeline
        # and shares the task's trace context with the executor-side span
        self._events.record(f"submit:{spec.name}", "submit", t_submit0,
                            trace=spec.trace)
        if streaming:
            from ray_tpu_torch.core.api import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, self.address)
        refs = [ObjectRef(o, owner=self.address) for o in oids]
        if n == 0:
            return []
        return refs[0] if n == 1 else refs

    # -------------------------------------------------- submit coalescing

    def flush_submits(self):
        """Force-flush coalesced submissions NOW. Called by every path
        about to BLOCK on a result (get/wait/stream iteration): the
        adaptive batch window must never sit on a latency-critical
        path — a sync call's submit leaves the process before its
        owner starts waiting."""
        self._submit_batcher.flush()

    def _flush_submit_batch(self, key, entries):
        """Batcher flush hook: one call_async per (kind, peer) batch,
        acked as a unit through the submit sweeper."""
        kind = key[0]
        if kind == "actor_calls":
            addr = key[1]
            fut = self.client.call_async(
                addr, "actor_calls", {"calls": [e[0] for e in entries]})

            def fail():
                for _msg, ab, task_id, obids in entries:
                    self._actor_push_failed(ab, task_id, obids)

            with self._lock:
                self._pending_acks.append(
                    [time.monotonic() + _ack_timeout(), fut, None, fail])
            _submit_coalesced("actor_call", len(entries))
        elif kind == "schedule_tasks":
            self._send_schedule_batch(key[1], list(entries))
            _submit_coalesced("task", len(entries))
        elif kind == "execute_leased":
            # entries share one lease (it is part of the key)
            lease = entries[0][0]
            self._push_leased(lease, [e[1] for e in entries])
            _submit_coalesced("lease", len(entries))

    def _send_schedule_batch(self, addr: str, specs: list, acks_left=2):
        """Push one batched schedule_tasks frame; the submit sweeper
        resends on a lost ack (nodelet-side (task_id, attempt) dedup
        absorbs a slow-but-delivered original) and fails the tasks
        retryably once resends are exhausted."""
        fut = self.client.call_async(
            addr, "schedule_tasks",
            {"specs": [dataclass_dict(s) for s in specs]})

        def resend():
            self._send_schedule_batch(addr, specs, acks_left - 1)

        def fail():
            for s in specs:
                self._task_failed(
                    s.return_oids,
                    exc.WorkerCrashedError(
                        f"task submission to {addr} failed"),
                    retryable=True)

        with self._lock:
            self._pending_acks.append(
                [time.monotonic() + _ack_timeout(), fut, resend,
                 fail if acks_left <= 0 else None])

    def _actor_push_failed(self, ab: bytes, task_id: bytes, obids: list):
        """An actor-call push never got its enqueue ack: worker presumed
        gone. First-writer-wins with task_done (a completed call whose
        ack reply was merely lost stays completed)."""
        with self._lock:
            done = task_id not in self._task_actor
            pend = self._inflight_actor.get(ab)
            if pend is not None:
                pend.pop(task_id, None)
            self._task_actor.pop(task_id, None)
            self._actor_addr.pop(ab, None)  # force re-resolve next call
        if not done:
            err = exc.ActorUnavailableError(
                "actor call delivery failed (no enqueue ack)")
            self._error_oids(obids, err)
            self._stream_fail(task_id, err)
            self._unpin_task_args(task_id)

    # locality only kicks in above this many serialized arg bytes — tiny
    # args are cheaper to move than a cross-node scheduling decision
    _LOCALITY_MIN_BYTES = 256 * 1024

    def _locality_target(self, ref_oids: list[bytes]) -> str | None:
        """Nodelet address holding the largest share of this task's
        store-resident args, if it is not the local nodelet (reference:
        lease_policy.h:58 best-locality node from the ownership table)."""
        if not ref_oids:
            return None
        by_addr: dict[str, int] = {}
        with self._lock:
            for b in ref_oids:
                st = self._owned.get(b)
                if st is None or not st.event.is_set() or \
                        st.location is None or st.size <= 0 or \
                        st.spilled_path is not None:
                    continue
                addr = (self.nodelet_address if st.location == "local"
                        else st.location)
                if addr:
                    by_addr[addr] = by_addr.get(addr, 0) + st.size
        if not by_addr:
            return None
        best = max(by_addr, key=by_addr.get)
        if best == self.nodelet_address or \
                by_addr[best] < self._LOCALITY_MIN_BYTES:
            return None
        return best

    # ------------------------------------------------------------ leases

    def _lease_key(self, spec: TaskSpec) -> tuple:
        return (json_stable(spec.resources), rtenv.env_hash(spec.runtime_env))

    def _submit_via_lease(self, spec: TaskSpec) -> bool:
        """Route the task through the lease layer (reference model: the
        core_worker queues tasks client-side and pushes one per granted
        lease, normal_task_submitter.cc:137).

        Selection order (parallelism first, then pipelining):
        1. an idle held lease (inflight == 0);
        2. a NEW lease while some nodelet grants one (spillback-following,
           with a short negative-cache backoff on denial);
        3. pipeline onto a lease below the depth cap;
        4. otherwise queue CLIENT-side — drained on task_done refills and
           by the sweeper's lease re-requests, so backlog can still move
           to new capacity (autoscaled nodes) instead of being committed
           to one worker's inbox.
        """
        key = self._lease_key(spec)
        now = time.monotonic()
        with self._lock:
            pool = self._lease_pools.setdefault(key, [])
            pool[:] = [le for le in pool if not le.broken]
            pending = self._lease_pending.setdefault(key, [])
            lease = next((le for le in pool if not le.inflight), None)
            need_new = (lease is None and len(pool) < self._lease_cap
                        and now > self._lease_backoff.get(key, 0.0))
        if need_new:
            lease = self._request_lease(key, spec)
            if lease is None:
                with self._lock:
                    self._lease_backoff[key] = now + 0.05
        with self._lock:
            # SUBMIT-time commits cap at 2 (one executing + one
            # buffered): a burst must stay CLIENT-side where it can
            # still move to newly granted leases on other nodes (the
            # autoscaler's scale-up feeds on exactly that mobility).
            # Only the completion-driven refill path (_refill_lease)
            # fills the full pipeline depth — a lease that is visibly
            # consuming tasks has earned a deep pipe.
            depth = min(2, _lease_depth())
            if lease is None or lease.broken:
                lease = min(
                    (le for le in pool
                     if not le.broken
                     and len(le.inflight) < depth),
                    key=lambda le: len(le.inflight), default=None)
            if lease is None:
                pending.append(spec)
                # ledger QUEUED: parked CLIENT-side waiting for a lease
                # grant — the verdict carries the resource request so
                # `explain` can compute per-node feasibility at the head
                self._ledger_event(
                    spec.task_id, spec.name, "QUEUED", trace=spec.trace,
                    verdict={"decision": "driver-pending-lease",
                             "resources": dict(spec.resources),
                             "constraint": "no nodelet currently grants "
                                           "a worker lease for these "
                                           "resources"})
                return True
            lease.inflight.add(spec.task_id)
            lease.last_active = time.monotonic()
            self._task_lease[spec.task_id] = (lease, spec)
        self._ledger_event(spec.task_id, spec.name, "LEASED",
                           trace=spec.trace,
                           detail=f"pipelined onto lease at {lease.address}")
        self._queue_leased_push(lease, spec)
        return True

    def _refill_lease(self, lease: _HeldLease):
        """Slots freed on this lease: push the next client-queued tasks
        (the OnWorkerIdle moment — keeps the pipe full without a sweeper
        round trip). Refills up to the pipeline depth and the whole
        refill rides ONE batched execute_leased frame."""
        with self._lock:
            depth = _lease_depth()
            pending = self._lease_pending.get(lease.key)
            if lease.broken or not pending:
                return
            if len(pending) <= depth:
                # SMALL backlog: keep it shallow (old depth-2 shape) so
                # the remainder stays client-side where the sweeper can
                # still move it to new capacity (autoscaler scale-up);
                # a deep pipe is only worth committing when the backlog
                # dwarfs what any one worker could absorb anyway. An
                # operator depth BELOW 2 still binds.
                depth = min(2, depth)
            gap = depth - len(lease.inflight)
            if gap <= 0:
                return
            specs = pending[:gap]
            del pending[:gap]
            for spec in specs:
                lease.inflight.add(spec.task_id)
                self._task_lease[spec.task_id] = (lease, spec)
            lease.last_active = time.monotonic()
        for spec in specs:
            # QUEUED (driver-pending) -> LEASED on the refill path
            self._ledger_event(spec.task_id, spec.name, "LEASED",
                               trace=spec.trace,
                               detail=f"refill onto lease at "
                                      f"{lease.address}")
            self._queue_leased_push(lease, spec)

    def _queue_leased_push(self, lease: _HeldLease, spec: TaskSpec):
        """Leased pushes ride the submit coalescer too: a tight submit
        loop's inline pushes (a lease with free depth takes every spec
        immediately) pack into multi-spec execute_leased frames instead
        of one zmq frame per task — the single biggest per-task cost on
        the steady-state path."""
        self._submit_batcher.append(
            ("execute_leased", id(lease), lease.address), (lease, spec))

    def _request_lease(self, key: tuple, spec: TaskSpec):
        """Ask the local nodelet for a worker lease, following spillback
        redirects to other nodes (reference: RequestWorkerLease spillback
        in the raylet; up to MAX_SPILLBACKS-style hop bound)."""
        target = self.nodelet_address
        for _hop in range(4):
            try:
                r = self.client.call(target, "request_lease", {
                    "resources": spec.resources,
                    "runtime_env": spec.runtime_env,
                    "owner": self.address,
                }, timeout=70)
            except Exception:  # noqa: BLE001
                return None
            if r.get("granted"):
                lease = _HeldLease(r["lease_id"], r["worker_id"],
                                   r["address"], key, target)
                with self._lock:
                    self._lease_pools.setdefault(key, []).append(lease)
                return lease
            spill = r.get("spill")
            if not spill or spill == target:
                return None
            target = spill
        return None

    # push transfer kicks in above this arg size (tiny args ride the pull)
    _PUSH_MIN_BYTES = 256 * 1024

    def _prefetch_args(self, exec_nodelet: str, spec: TaskSpec):
        """Owner-directed push of large args toward the execution node
        (reference: push_manager.h:30) — fire-and-forget; overlaps the
        transfer with scheduling/queueing latency."""
        if not exec_nodelet:
            return
        for a in list(spec.args) + list(spec.kwargs.values()):
            if not isinstance(a, RefArg):
                continue
            with self._lock:
                st = self._owned.get(a.oid)
            if st is None or not st.event.is_set() or \
                    st.size < self._PUSH_MIN_BYTES or \
                    st.spilled_path is not None or st.location is None:
                continue
            src = (self.nodelet_address if st.location == "local"
                   else st.location)
            if not src or src == exec_nodelet:
                continue
            try:
                self.client.send_oneway(exec_nodelet, "prefetch_object",
                                        {"oid": a.oid, "location": src})
            except Exception:  # noqa: BLE001
                pass

    def _push_leased(self, lease: _HeldLease, specs: list,
                     acks_left: int = 2):
        """Push up to a pipeline-depth's worth of specs to the leased
        worker in ONE execute_leased frame (one socket write, one
        shared enqueue-ack); worker-side (task_id, attempt) dedup makes
        resends of the whole frame harmless."""
        if acks_left == 2 and lease.nodelet != self.nodelet_address:
            for spec in specs:
                self._prefetch_args(lease.nodelet, spec)
        fut = self.client.call_async(
            lease.address, "execute_leased",
            {"specs": [dataclass_dict(s) for s in specs],
             "attempts": [s.attempt for s in specs],
             "lease_id": lease.lease_id})

        def resend():
            self._push_leased(lease, specs, acks_left - 1)

        def fail():
            # enqueue-ack never arrived: worker presumed gone; the tasks
            # become retryable failures (dedup at the worker makes a
            # slow-but-delivered original harmless)
            for spec in specs:
                self._lease_task_failed(lease, spec)

        def stale():
            # rejected BEFORE execution (StaleLeaseError): never charge
            # the retry budget and never resend to the dead lease
            for spec in specs:
                self._lease_task_requeue(lease, spec)

        with self._lock:
            self._pending_acks.append(
                [time.monotonic() + _ack_timeout(), fut, resend,
                 fail if acks_left <= 0 else None, stale])

    def _lease_task_requeue(self, lease: _HeldLease, spec: TaskSpec):
        """A push the worker REJECTED before execution (stale lease id):
        the task provably never ran, so re-enter it in the client-side
        pending queue — a fresh lease picks it up on the next sweep —
        without consuming its retry budget (that budget is for tasks
        that may have executed)."""
        with self._lock:
            ent = self._task_lease.pop(spec.task_id, None)
            if ent is None:
                return  # completed/failed through another path meanwhile
            lease.inflight.discard(spec.task_id)
            lease.broken = True
            pool = self._lease_pools.get(lease.key)
            if pool is not None and lease in pool:
                pool.remove(lease)
            self._lease_pending.setdefault(lease.key, []).append(spec)

    def _lease_task_failed(self, lease: _HeldLease, spec: TaskSpec):
        with self._lock:
            ent = self._task_lease.pop(spec.task_id, None)
            if ent is None:
                return  # completed meanwhile
            lease.inflight.discard(spec.task_id)
            # a definitive push failure (worker unreachable or stale-lease
            # rejection) means this lease is dead: stop refilling it
            lease.broken = True
            pool = self._lease_pools.get(lease.key)
            if pool is not None and lease in pool:
                pool.remove(lease)
        self._task_failed(
            spec.return_oids,
            exc.WorkerCrashedError(
                f"leased worker for {spec.name} became unreachable"),
            retryable=True)

    def _h_lease_broken(self, msg, frames):
        """Nodelet reports a leased worker died: resubmit our in-flight
        pushes (retryable — honors each task's retry budget)."""
        lease_id = msg["lease_id"]
        with self._lock:
            victims = []
            for pool in self._lease_pools.values():
                for le in pool:
                    if le.lease_id == lease_id:
                        le.broken = True
                        victims = [self._task_lease[tid]
                                   for tid in list(le.inflight)
                                   if tid in self._task_lease]
                pool[:] = [le for le in pool if not le.broken]
        for lease, spec in victims:
            self._lease_task_failed(lease, spec)

    def _submit_sweeper(self):
        """Background loop: submission-ack timeouts/retries, lease renewal,
        and idle-lease return."""
        while not self._shutdown_flag:
            time.sleep(0.25)
            self._flush_deferred_sends()
            self._flush_ledger_events()
            now = time.monotonic()
            resend, fail, stale = [], [], []
            with self._lock:
                remaining = []
                for ent in self._pending_acks:
                    deadline, fut, resend_fn, fail_fn = ent[:4]
                    if fut.done() and fut.exception() is None:
                        continue  # acked
                    if fut.done() and len(ent) > 4 and isinstance(
                            fut.exception(), exc.StaleLeaseError):
                        # definitive pre-execution rejection: resending to
                        # the same dead lease can only fail again
                        stale.append(ent)
                    elif fut.done() or now > deadline:
                        # failed or timed out: resend while retries remain
                        # (fail_fn is set only once retries are exhausted)
                        (fail if fail_fn is not None or resend_fn is None
                         else resend).append(ent)
                    else:
                        remaining.append(ent)
                self._pending_acks = remaining
            for ent in stale:
                try:
                    ent[4]()
                except Exception:  # noqa: BLE001
                    pass
            for ent in resend:
                try:
                    ent[2]()
                except Exception:  # noqa: BLE001
                    pass
            for ent in fail:
                if ent[3] is not None:
                    try:
                        ent[3]()
                    except Exception:  # noqa: BLE001
                        pass
            self._sweep_leases(now)

    def _sweep_leases(self, now: float):
        to_return = []
        renew_by_nodelet: dict[str, list[bytes]] = {}
        backlog = 0
        grow = []  # (key, example spec) with client-queued backlog
        with self._lock:
            for key, pool in self._lease_pools.items():
                keep = []
                for le in pool:
                    if not le.inflight and \
                            now - le.last_active > _LEASE_IDLE_RETURN_S:
                        to_return.append(le)
                    else:
                        keep.append(le)
                        renew_by_nodelet.setdefault(
                            le.nodelet, []).append(le.lease_id)
                        # tasks buffered BEHIND the executing one are
                        # unmet demand the cluster can't see — count them
                        # toward the autoscaler's backlog signal
                        backlog += max(0, len(le.inflight) - 1)
                pool[:] = keep
            for key, pending in self._lease_pending.items():
                backlog += len(pending)
                if pending and \
                        len(self._lease_pools.get(key, ())) < self._lease_cap \
                        and now > self._lease_backoff.get(key, 0.0):
                    grow.append((key, pending[0]))
        # client-queued backlog: try to grow capacity (new nodes may have
        # appeared — autoscaler scale-up, lease returns elsewhere)
        for key, spec in grow:
            lease = self._request_lease(key, spec)
            if lease is None:
                with self._lock:
                    self._lease_backoff[key] = now + 0.5
            else:
                self._refill_lease(lease)  # fills to depth in one frame
        if self.nodelet_address and (backlog or self._last_backlog):
            self._last_backlog = backlog
            try:
                self.client.send_oneway(self.nodelet_address, "lease_demand",
                                        {"owner": self.address,
                                         "count": backlog})
            except Exception:  # noqa: BLE001
                pass
        for le in to_return:
            try:
                self.client.send_oneway(le.nodelet, "return_lease",
                                        {"lease_id": le.lease_id})
            except Exception:  # noqa: BLE001
                pass
        # renew well under TTL/3 (30s TTL): renews are best-effort oneways
        # and a couple of drops must not let a live lease expire
        if renew_by_nodelet and now - self._last_renew > 5.0:
            self._last_renew = now
            for nodelet, ids in renew_by_nodelet.items():
                try:
                    self.client.send_oneway(nodelet, "renew_leases",
                                            {"lease_ids": ids})
                except Exception:  # noqa: BLE001
                    pass

    def _pg_node_address(self, pg_id: bytes, bundle_index: int, resources):
        try:
            info = self.client.call(self.head_address, "pg_table",
                                    {"pg_id": pg_id}, timeout=10)
            if info.get("state") != "CREATED":
                return None
            nodes = info["nodes"]
            idx = bundle_index if 0 <= bundle_index < len(nodes) else 0
            target_node = bytes.fromhex(nodes[idx])
            view = self.client.call(self.head_address, "cluster_view", {},
                                    timeout=10)
            for nd in view["nodes"]:
                if nd["node_id"] == target_node:
                    return nd["address"]
        except Exception:
            return None
        return None

    def cancel(self, ref: ObjectRef, force=False, recursive=True):
        with self._lock:
            st = self._owned.get(ref.id.binary())
            if st is not None:
                st.cancelled = True
                st.retries_left = 0

    # ------------------------------------------------------------ actors

    def create_actor(self, cls, args, kwargs, opts: ActorOptions) -> ActorHandle:
        aid = ActorID.random()
        eargs, ekwargs, ref_oids = self._encode_args(args, kwargs)
        # init-arg refs stay pinned for the actor's lifetime (restarts
        # re-resolve them); unpinned when the actor is reported dead.
        self._pin_task_args(aid.binary(), ref_oids)
        pg = opts.placement_group
        spec = ActorSpec(
            actor_id=aid.binary(),
            cls_blob=b"",
            args=eargs,
            kwargs=ekwargs,
            name=opts.name,
            namespace=opts.namespace or self.namespace,
            owner=self.address,
            resources=opts.resource_request(),
            max_restarts=opts.max_restarts,
            max_concurrency=opts.max_concurrency,
            concurrency_groups=opts.concurrency_groups,
            lifetime=opts.lifetime,
            placement_group=pg.id.binary() if pg is not None else None,
            bundle_index=opts.placement_group_bundle_index,
            label_selector=opts.label_selector,
            runtime_env=self._normalized_runtime_env(opts.runtime_env),
        )
        blob = ser.dumps_fn(cls)
        r = self.client.call(self.head_address, "create_actor",
                             {"spec": dataclass_dict(spec),
                              "get_if_exists": opts.get_if_exists},
                             frames=[blob], timeout=60)
        actor_id = ActorID(r["actor_id"])
        meta = {}
        for mname in dir(cls):
            m = getattr(cls, mname, None)
            if callable(m) and hasattr(m, "__ray_tpu_method_options__"):
                meta[mname] = m.__ray_tpu_method_options__
        with self._lock:
            self._actor_meta[actor_id.binary()] = meta
        return ActorHandle(actor_id, meta)

    def _resolve_actor(self, actor_id: bytes, timeout=60.0) -> str:
        with self._lock:
            addr = self._actor_addr.get(actor_id)
        if addr is not None:
            return addr
        r = self.client.call(self.head_address, "get_actor",
                             {"actor_id": actor_id, "wait": True,
                              "timeout": timeout}, timeout=timeout + 10)
        if r["state"] == "ALIVE":
            with self._lock:
                self._actor_addr[actor_id] = r["address"]
            return r["address"]
        if r["state"] == "UNKNOWN":
            raise exc.ActorDiedError("no such actor")
        if r["state"] == "DEAD":
            raise exc.ActorDiedError(r.get("cause") or "actor is dead")
        raise exc.ActorUnavailableError(
            f"actor {actor_id.hex()[:12]} not ready ({r['state']})")

    def submit_actor_task(self, actor_id: ActorID, mname: str, args, kwargs,
                          mopts: dict):
        nr = mopts.get("num_returns", 1)
        streaming = nr in ("streaming", "dynamic")
        n = 1 if streaming else int(nr)
        oids = [ObjectID.random() for _ in range(n)]
        eargs, ekwargs, ref_oids = self._encode_args(args, kwargs)
        ab = actor_id.binary()
        task_id = TaskID.random().binary()
        with self._lock:
            for o in oids:
                self._owned[o.binary()] = _Owned(label=mname)
            if streaming:
                self._streams[task_id] = _StreamState(oids[0].binary())
        self._pin_task_args(task_id, ref_oids)
        msg = {
            "actor_id": ab,
            "task_id": task_id,
            "method": mname,
            "args": eargs,
            "kwargs": ekwargs,
            "oids": [o.binary() for o in oids],
            "owner": self.address,
        }
        if mopts.get("concurrency_group"):
            msg["concurrency_group"] = mopts["concurrency_group"]
        if streaming:
            msg["streaming"] = True
            msg["backpressure"] = int(
                mopts.get("generator_backpressure_num_objects") or 0)
        msg["trace"] = _child_trace(self._ctx.trace)
        if streaming:
            # streaming actor calls always ride the pipelined at-most-once
            # path (a mid-stream duplicate execution would interleave two
            # producers into one order book)
            from ray_tpu_torch.core.api import ObjectRefGenerator

            self._submit_actor_pipelined(ab, task_id, msg, oids)
            return ObjectRefGenerator(task_id, self.address)
        # At-most-once by default (reference: actor tasks are not retried
        # unless max_task_retries>0, python/ray/actor.py): once a push may
        # have been DELIVERED (it timed out rather than failing to send),
        # re-sending could execute the method twice — or, for a call that
        # killed the actor, kill every restart and burn the whole restart
        # budget. Opt-in retries re-resolve the (possibly restarted) actor.
        tries = 1 + int(mopts.get("max_task_retries", 0) or 0)
        if tries == 1:
            # hot path: PIPELINED push — don't block on the enqueue-ack
            # (the result arrives via task_done; the ack only guards
            # delivery). The submit sweeper errors the oids if the ack
            # never lands; actor-death pubsub covers a dead peer.
            self._submit_actor_pipelined(ab, task_id, msg, oids)
            refs = [ObjectRef(o, owner=self.address) for o in oids]
            return refs[0] if n == 1 else refs
        last_err = None
        # the whole retry loop shares ONE deadline (the submission-ack
        # budget): backoff sleeps and per-attempt RPC timeouts both
        # shrink to the remaining budget, so opt-in retries never hold
        # the caller past the window a single delivery attempt gets
        deadline = time.monotonic() + _ack_timeout()
        self._ledger_event(task_id, mname, "SUBMITTED", kind="ACTOR_TASK",
                           trace=msg.get("trace"))
        for attempt in range(tries):
            try:
                addr = self._resolve_actor(ab)
            except exc.RayTpuError as e:
                self._error_oids([o.binary() for o in oids], e)
                self._unpin_task_args(task_id)
                last_err = None
                break
            # register BEFORE the push: a fast task_done must find the
            # entry to pop, or it leaks until actor death (and is then
            # spuriously failure-processed)
            with self._lock:
                self._inflight_actor.setdefault(ab, {})[task_id] = \
                    [o.binary() for o in oids]
                self._task_actor[task_id] = ab
            try:
                # flush coalesced pushes to this worker first so the
                # direct call cannot overtake buffered earlier calls
                self._submit_batcher.flush(("actor_calls", addr))
                # each attempt gets an equal slice of the REMAINING
                # budget: a dropped first send can never starve the
                # retries of their window (worker-side task_id dedup
                # keeps a slow-but-delivered original exactly-once)
                per_attempt = max(
                    1.0, (deadline - time.monotonic()) / (tries - attempt))
                self.client.call(addr, "actor_call", msg,
                                 timeout=min(30.0, per_attempt))
                last_err = None
                break
            except PeerUnavailableError as e:
                last_err = e
                with self._lock:
                    pend = self._inflight_actor.get(ab)
                    if pend is not None:
                        pend.pop(task_id, None)
                    self._task_actor.pop(task_id, None)
                    self._actor_addr.pop(ab, None)  # force re-resolve
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # exponential backoff with jitter (was a flat 0.2s):
                # doubling desyncs a retry herd hammering one restarting
                # actor, the jitter keeps clients from re-aligning
                delay = min(0.05 * (2 ** attempt), 2.0)
                delay *= 0.5 + random.random()
                time.sleep(min(delay, remaining))
        if last_err is not None:
            self._error_oids(
                [o.binary() for o in oids],
                exc.ActorUnavailableError(f"actor unreachable: {last_err}"))
            self._unpin_task_args(task_id)
        refs = [ObjectRef(o, owner=self.address) for o in oids]
        return refs[0] if n == 1 else refs

    def _submit_actor_pipelined(self, ab: bytes, task_id: bytes, msg: dict,
                                oids):
        t_submit0 = time.monotonic_ns()
        # flow control: bound unacked pushes (worker-side dedup window is
        # 20k; runaway submit loops must not queue unbounded memory)
        while True:
            with self._lock:
                n_acks = len(self._pending_acks)
            if n_acks + self._submit_batcher.pending_count() < 10000:
                break
            time.sleep(0.001)
        obids = [o.binary() for o in oids]
        try:
            addr = self._resolve_actor(ab)
        except exc.RayTpuError as e:
            self._error_oids(obids, e)
            self._stream_fail(task_id, e)
            self._unpin_task_args(task_id)
            return
        # register BEFORE the push: a fast task_done must find the entry
        with self._lock:
            self._inflight_actor.setdefault(ab, {})[task_id] = obids
            self._task_actor[task_id] = ab
        # the push rides the submit coalescer: N calls to the same
        # worker become ONE actor_calls frame with one shared
        # enqueue-ack (was: one encode + one socket write + one ack
        # entry per call). Per-actor order is preserved: one buffer per
        # worker address, flushed FIFO under the batcher lock, and the
        # worker enqueues a frame's calls in order from one dispatch.
        self._submit_batcher.append(("actor_calls", addr),
                                    (msg, ab, task_id, obids))
        self._ledger_event(task_id, msg["method"], "SUBMITTED",
                           kind="ACTOR_TASK", trace=msg.get("trace"))
        self._events.record(f"submit:{msg['method']}", "actor_submit",
                            t_submit0, trace=msg.get("trace"))

    @staticmethod
    def _raise_stored(error: BaseException):
        """Re-raise an error retained in owner state as a FRESH copy.

        Raising the stored object directly would attach a traceback to
        it whose frames reference the very ObjectRefs being fetched —
        a cycle rooted in _owned that pins their refcounts forever
        (stranded oids). A pickled round trip raises a tb-free clone,
        like the reference deserializing a new RayTaskError per get."""
        try:
            fresh = ser.loads_msg(ser.dumps_msg(error))
        except Exception:  # noqa: BLE001
            error.__traceback__ = None  # last resort: never pin frames
            fresh = error
        raise fresh

    def _error_oids(self, oids, error):
        # strip any traceback picked up on the way here: stored
        # exceptions must never retain submit-path frames (they
        # reference the submitted refs — see _raise_stored)
        error.__traceback__ = None
        for b in oids:
            with self._lock:
                st = self._owned.get(b)
            if st is not None and not st.event.is_set():
                # first writer wins: never clobber a delivered result with
                # a late failure signal (e.g. pubsub death racing task_done)
                st.error = error
                st.event.set()

    def kill_actor(self, actor_id: ActorID, no_restart=True):
        self.client.call(self.head_address, "kill_actor",
                         {"actor_id": actor_id.binary(),
                          "no_restart": no_restart}, timeout=30)

    def get_named_actor(self, name: str, namespace=None) -> ActorHandle:
        r = self.client.call(self.head_address, "get_named_actor",
                             {"name": name,
                              "namespace": namespace or self.namespace},
                             timeout=30)
        if not r.get("found"):
            raise ValueError(f"no live actor named {name!r}")
        aid = ActorID(r["actor_id"])
        with self._lock:
            meta = self._actor_meta.get(aid.binary(), {})
        return ActorHandle(aid, meta)

    # ------------------------------------------------------------ cluster info

    def nodes(self):
        view = self.client.call(self.head_address, "cluster_view", {}, timeout=10)
        return [
            {
                "NodeID": n["node_id"].hex(),
                "Alive": n["alive"],
                "Resources": n["resources"],
                "Available": n["available"],
                "Labels": n["labels"],
                "NodeManagerAddress": n["address"],
            }
            for n in view["nodes"]
        ]

    def cluster_resources(self):
        out: dict[str, float] = {}
        for n in self.nodes():
            if not n["Alive"]:
                continue
            for r, q in n["Resources"].items():
                out[r] = out.get(r, 0.0) + q
        return out

    def available_resources(self):
        out: dict[str, float] = {}
        for n in self.nodes():
            if not n["Alive"]:
                continue
            for r, q in n["Available"].items():
                out[r] = out.get(r, 0.0) + q
        return out

    def runtime_context(self):
        from ray_tpu_torch.core.runtime_context import RuntimeContext

        return RuntimeContext(
            job_id=self.job_id,
            node_id=self.node_id,
            worker_id=self.worker_id,
            actor_id=self._ctx.actor_id,
            task_id=self._ctx.task_id,
            namespace=self.namespace,
        )

    def _ledger_event(self, task_id: bytes, name: str, state: str,
                      kind: str = "NORMAL_TASK",
                      trace: dict | None = None,
                      detail: str | None = None,
                      verdict: dict | None = None):
        """Queue one owner-side lifecycle transition for the head task
        ledger (flushed by the submit sweeper over the task_events
        oneway lane — the same buffered-batch discipline workers use)."""
        ev = {"task_id": task_id.hex(), "name": name, "state": state,
              "type": kind, "trace_id": (trace or {}).get("trace_id", ""),
              "time": time.time()}
        if detail:
            ev["detail"] = detail
        if verdict is not None:
            ev["verdict"] = verdict
        with self._lock:
            if len(self._ledger_buf) >= 5000:
                self._ledger_drops += 1
            else:
                self._ledger_buf.append(ev)

    def _flush_ledger_events(self):
        with self._lock:
            if not self._ledger_buf:
                return
            batch, self._ledger_buf = self._ledger_buf, []
        try:
            self.client.send_oneway(self.head_address, "task_events",
                                    {"events": batch})
        except Exception:  # noqa: BLE001
            # observability events: drop the batch (counted) rather than
            # grow an unbounded retry pile on a dead head
            with self._lock:
                self._ledger_drops += len(batch)

    def _drain_tagged_spans(self) -> list[dict]:
        """Drain the local span buffer, stamped with this process's
        node/proc identity — the ONE implementation of the tagging
        contract, shared by the worker flush loop and the driver-side
        timeline dump."""
        spans = self._events.drain()
        if not spans:
            return spans
        node = self.node_id.hex() if self.node_id else "driver"
        proc = (self.worker_id_bytes.hex()
                if hasattr(self, "worker_id_bytes")
                else f"driver-{os.getpid()}")
        for s in spans:
            s["node"] = node
            s["proc"] = proc
        return spans

    def timeline(self, filename=None):
        """MERGED cluster timeline: our local spans ride INSIDE the
        dump request (one two-way RPC — no ordering to arrange between
        a flush and the dump), the head appends them and returns its
        whole span buffer — every node's workers plus this driver — as
        one chrome trace with pid=node, tid=worker/thread and
        epoch-aligned timestamps."""
        spans = self._drain_tagged_spans()
        try:
            r = self.client.call(self.head_address, "dump_timeline",
                                 {"spans": spans}, timeout=30)
        except Exception:  # noqa: BLE001
            # The failure is ambiguous (timeout and socket reset can both
            # mean the head STORED the spans but the reply was lost), so
            # spans are never requeued — at-most-once resolves ambiguity
            # without ever rendering a span twice. The drained batch is
            # still shown to THIS caller by merging it locally.
            return merge_spans(spans, filename)
        return merge_spans(r["spans"], filename)

    def context_info(self):
        return {"head_address": self.head_address, "node_id":
                self.node_id.hex() if self.node_id else None,
                "local_mode": False}

    def shutdown(self):
        if self._shutdown_flag:
            return
        self._shutdown_flag = True
        atexit.unregister(self.shutdown)
        try:
            self._submit_batcher.close()  # coalesced submits leave now
        except Exception:  # noqa: BLE001
            pass
        self._flush_deferred_sends()  # don't drop queued frees
        self._flush_ledger_events()  # ship buffered lifecycle events
        # hand leased workers back (the nodelet's TTL would reclaim them,
        # but a clean return keeps the pool warm for the next driver)
        with self._lock:
            held = [le for pool in self._lease_pools.values() for le in pool]
            self._lease_pools.clear()
        if held:
            # SYNCHRONOUS returns under ONE shared deadline: callers
            # like the client host os._exit right after shutdown()
            # returns, and a oneway still sitting in the batcher (or
            # zmq's io thread) at exit silently strands every leased
            # worker on the nodelet until the 30s lease TTL reclaims
            # it — the test_client.test_wait wedge: 4 dead drivers'
            # stale leases saturated a 4-worker pool. The replies are
            # the delivery guarantee; dead nodelets cost 2s TOTAL
            # (call_gather reclaims timed-out slots).
            try:
                self.client.call_gather(
                    [(le.nodelet, "return_lease",
                      {"lease_id": le.lease_id}) for le in held],
                    timeout=2)
            except Exception:  # noqa: BLE001
                pass
        # queued frees still ride the batcher — flush before exit paths
        try:
            self.client.flush_oneways()
        except Exception:  # noqa: BLE001
            pass
        self.server.stop()
        for oid in list(self._pins):
            self._release_pin(oid)
        for svc in reversed(self._booted):
            try:
                svc.stop()
            except Exception:
                pass
        booted, self._booted = bool(self._booted), []
        if booted:
            # this driver booted the process's cluster: close the shared
            # client's sockets and thread with it (a test process must
            # not accumulate them); a later init() makes a new one
            RpcClient.reset_shared()
        # The store mapping is intentionally NOT unmapped here: late
        # handler-pool threads (a queued free_object / resolve) and
        # zero-copy memoryviews handed to user code may still reference
        # the shm pages — unmapping under them is a SIGSEGV, not an
        # exception. The name is unlinked by the nodelet that owns the
        # segment; the pages drop with the last process mapping.
        # A driver that only connected (address=...) leaves the shared
        # RpcClient alive: other in-process services (test Cluster
        # fixtures) share it.


def json_stable(d) -> str:
    import json

    return json.dumps(d, sort_keys=True, default=str)
