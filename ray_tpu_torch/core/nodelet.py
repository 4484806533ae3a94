"""Nodelet — the per-node agent.

Reference parity: the raylet (src/ray/raylet/raylet.h, node_manager.h:117)
composed of: WorkerPool (worker_pool.h:216 — spawn/cache worker
processes), local scheduling with resource instances
(local_task_manager.h:58 — dispatch loop + spillback), the local object
store host, and node→node object transfer (object_manager.h:117 pull
protocol). One nodelet per node; it owns the shm object-store segment
that all local workers map.

Scheduling follows the reference's two-level design: submitters send
tasks to a nodelet; the nodelet either dispatches locally (resources +
an idle/new worker) or spills to the best other node using the cluster
view gossiped via head heartbeats (hybrid policy:
raylet/scheduling/policy/hybrid_scheduling_policy.h:50 — prefer local
until saturated, then best-fit remote).

The port's copy of ``ray_tpu/core/nodelet.py``. Workers run
``python -m ray_tpu_torch.core.worker_main`` and see the card exactly
when they claim ``GPU`` (the accelerator registry's handoff), in a
runtime environment as well; a worker exits when its nodelet's process
goes. The node serves the observability planes: the structured log
plane's query (log_query), the node's metrics page (node_metrics) and
the profiler (profile_capture), each over this node's workers.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

from ray_tpu_torch.core import config as cfg
from ray_tpu_torch.core import runtime_env as rtenv
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.head import HEARTBEAT_INTERVAL_S, dataclass_dict
from ray_tpu_torch.core.object_store import open_store
from ray_tpu_torch.core.rpc import RpcClient, RpcServer
from ray_tpu_torch.core.specs import ActorSpec, TaskSpec

_log = logging.getLogger("ray_tpu_torch.nodelet")




class _Worker:
    __slots__ = ("worker_id", "proc", "address", "idle", "current_task",
                 "actor_id", "ready", "acquired", "gpu", "bundle",
                 "env_hash", "lease_id", "assigned_time", "oom_kill_retry",
                 "oom_meta", "spawned_at", "ready_s")

    def __init__(self, worker_id: bytes, proc, gpu: bool = False,
                 env_hash: str = ""):
        self.worker_id = worker_id
        self.proc = proc
        self.address = None
        self.idle = False
        self.current_task = None  # TaskSpec being executed
        self.assigned_time = 0.0  # when current work (task/lease) arrived
        self.oom_kill_retry = None  # set by the OOM killer before SIGKILL
        self.oom_meta = None  # (owner, retriable) for actor workers
        self.actor_id = None  # set for dedicated actor workers
        self.ready = threading.Event()
        # resources this worker currently holds (task or actor); released
        # exactly once on finish/death (reference: LocalResourceManager
        # instance accounting, raylet/scheduling/local_resource_manager.h:55)
        self.acquired: dict[str, float] = {}
        self.bundle = None  # ((pg_id, idx), resources) for PG-metered work
        self.gpu = gpu  # spawned with GPU device visibility
        self.spawned_at = time.monotonic()
        self.ready_s = None  # spawn to worker_ready, seconds
        self.env_hash = env_hash  # runtime-env identity for reuse matching
        self.lease_id = None  # held by a submitter for direct task pushes


class _Lease:
    """A worker granted to one submitter for repeated direct pushes
    (reference: worker lease reuse, normal_task_submitter.cc:137)."""

    __slots__ = ("lease_id", "worker", "owner", "resources", "expiry")

    def __init__(self, lease_id, worker, owner, resources, expiry):
        self.lease_id = lease_id
        self.worker = worker
        self.owner = owner
        self.resources = resources
        self.expiry = expiry


LEASE_TTL_S = 30.0


def _fpq(x: float) -> float:
    """Quantize a resource quantity to 1/10000 (reference: FixedPoint
    arithmetic, src/ray/common/scheduling/fixed_point.h) so repeated
    fractional acquire/release (0.1 CPU) cannot drift the ledger."""
    return round(x * 10000.0) / 10000.0


def _stop_process(proc, grace_s: float) -> None:
    """Wait `grace_s` for a worker told to go, then kill it and wait
    until it is gone: a worker that holds a card can take seconds to
    exit, and one left behind outlives the node."""
    try:
        proc.wait(timeout=grace_s)
        return
    except Exception:  # noqa: BLE001
        pass
    try:
        proc.kill()
        proc.wait(timeout=30)
    except Exception:  # noqa: BLE001
        pass


class Nodelet:
    def __init__(self, head_address: str, resources: dict[str, float],
                 labels: dict[str, str] | None = None,
                 session_dir: str | None = None,
                 store_capacity: int | None = None,
                 node_id: bytes | None = None):
        from ray_tpu_torch.core.ids import NodeID

        self.node_id = node_id or NodeID.random().binary()
        self.head_address = head_address
        self.resources = dict(resources)
        self.labels = dict(labels or {})
        # every node is addressable by id through the label scheduler
        # (reference: NodeAffinitySchedulingStrategy,
        # node_affinity_scheduling_policy.h:29 — here node affinity IS a
        # label match on this auto-label)
        self.labels.setdefault("ray.io/node-id", self.node_id.hex())
        # slice identity: merge env-detected labels (real TPU VMs) under
        # any asserted ones, and assert the slice-head marker resource on
        # worker 0 (reference: accelerators/tpu.py TPU-{pod}-head)
        from ray_tpu_torch.core import tpu as tpu_mod

        if self.resources.get("TPU", 0) > 0:
            for k, v in tpu_mod.detect_slice_labels().items():
                self.labels.setdefault(k, v)
            for r, q in tpu_mod.head_marker_resources(self.labels).items():
                self.resources.setdefault(r, q)
        self.session_dir = session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu")
        self.log_dir = os.path.join(session_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)

        kw = {"capacity": store_capacity} if store_capacity else {}
        self.store = open_store(**kw)
        self.client = RpcClient.shared()
        self.server = RpcServer(name="nodelet", num_threads=32)
        self.address = self.server.address

        self._lock = threading.RLock()
        self._available = dict(self.resources)  # guarded_by(_lock)
        self._queue: deque[TaskSpec] = deque()  # guarded_by(_lock)
        # resources demanded by queued (not yet dispatched) non-PG tasks:
        # _place must see them or a submission burst that outraces the
        # dispatch thread all lands locally instead of spilling
        self._queued_demand: dict[str, float] = {}  # guarded_by(_lock)
        # task_id -> queued at; guarded_by(_lock)
        self._enqueue_time: dict[bytes, float] = {}
        self._workers: dict[bytes, _Worker] = {}  # guarded_by(_lock)
        self._idle_workers: deque[_Worker] = deque()  # guarded_by(_lock)
        # (pg_id, idx) -> reserved; guarded_by(_lock)
        self._bundles: dict[tuple, dict] = {}
        # (pg_id, idx) -> remaining; guarded_by(_lock)
        self._bundle_free: dict[tuple, dict] = {}
        self._leases: dict[bytes, _Lease] = {}  # lease_id; guarded_by(_lock)
        # bounded concurrent inbound object pulls (pull admission control)
        self._pull_sem = threading.BoundedSemaphore(4)
        self._pull_waiters = 0  # guarded_by(_lock)
        # submitter-reported pipelined backlog: owner -> (expiry, count).
        # Feeds the heartbeat queue_len so the autoscaler sees demand that
        # never materializes as nodelet-queued tasks.
        self._lease_demand: dict[str, tuple[float, int]] = {}  # guarded_by(_lock)
        self._cluster_view = []  # guarded_by(_lock)
        self._view_ts = 0.0  # guarded_by(_lock)
        # chunked-transfer observability; guarded_by(_lock)
        self._pull_chunks_served = 0
        self._stopped = threading.Event()
        self._dispatch_wake = threading.Event()
        # At-least-once RPC dedup: schedule_task may be retried by a
        # submitter whose first reply was slow (not lost); executing the
        # same TaskSpec twice duplicates side effects. Keyed by
        # (task_id, attempt, spillback_count) so legitimate retries and
        # respill hops pass. Bounded FIFO eviction.
        self._seen_tasks: set[tuple] = set()  # guarded_by(_lock)
        self._seen_tasks_order: deque[tuple] = deque()  # guarded_by(_lock)
        # Worker-pool cap (reference: WorkerPool caps by cores,
        # raylet/worker_pool.h:216). Actors get dedicated processes and
        # are gated by resources instead.
        env_cap = cfg.get("MAX_WORKERS")
        self._max_task_workers = (env_cap if env_cap else
                                  max(2, int(self.resources.get("CPU", 0) or
                                             (os.cpu_count() or 8))))
        # spawns in flight (lease path): counted against the cap so N
        # concurrent lease requests can't all pass the check and overshoot
        self._pending_spawns = 0  # guarded_by(_lock)
        self._last_memory_check = 0.0  # reap thread only
        self._oom_kills = 0  # surfaced in node_info; guarded_by(_lock)

        # object-plane transfer observability (reference: object manager
        # metrics), scraped cluster-wide via node_metrics. Metrics live
        # in a PRIVATE registry: in-process test clusters run several
        # nodelets in one process, and process-global same-name gauges
        # would alias across nodes — per-node attribution must stay
        # exact in exactly the topology the tests exercise.
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, Registry

        self._metrics_registry = Registry()
        self._m_pull_bytes = Counter(
            "object_store_pull_bytes_total",
            "Bytes pulled into this node's store from other nodes",
            registry=self._metrics_registry)
        self._m_pull_seconds = Histogram(
            "object_store_pull_seconds",
            "Inbound object transfer latency (whole object)",
            boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30),
            registry=self._metrics_registry)
        self._m_push_bytes = Counter(
            "object_store_push_bytes_total",
            "Bytes served out of this node's store to other nodes",
            registry=self._metrics_registry)
        self._m_store_allocated = Gauge(
            "object_store_bytes_allocated", "Store bytes in use",
            registry=self._metrics_registry)
        self._m_store_objects = Gauge(
            "object_store_num_objects", "Objects resident in the store",
            registry=self._metrics_registry)
        self._m_store_evictions = Gauge(
            "object_store_evictions", "Cumulative store evictions "
            "(gauge mirror of the store's counter, set at scrape)",
            registry=self._metrics_registry)
        self._m_queue_wait = Histogram(
            "task_queue_wait_seconds",
            "Time tasks spend in this nodelet's dispatch queue "
            "(enqueue to dispatch)",
            boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120),
            registry=self._metrics_registry)
        # task lifecycle ledger outbox: scheduler-side QUEUED/DISPATCHED/
        # SCHEDULED/FAILED transitions buffered here and flushed to the
        # head's task_events lane by the heartbeat loop. Capped with
        # drops counted — a head outage must not grow this without bound.
        self._ledger_buf: list[dict] = []  # guarded_by(_lock)
        self._ledger_drops = 0  # guarded_by(_lock)

        s = self.server
        s.register("schedule_task", self._h_schedule_task)
        s.register("schedule_tasks", self._h_schedule_tasks)
        s.register("start_actor", self._h_start_actor)
        s.register("stop_actor", self._h_stop_actor)
        s.register("worker_ready", self._h_worker_ready)
        s.register("task_finished", self._h_task_finished, oneway=True)
        s.register("fetch_object", self._h_fetch_object, slow=True)
        s.register("object_meta", self._h_object_meta)
        s.register("pull_chunk", self._h_pull_chunk)
        s.register("pull_object", self._h_pull_object)
        s.register("free_object", self._h_free_object, oneway=True)
        s.register("prefetch_object", self._h_prefetch_object, oneway=True)
        s.register("reserve_bundle", self._h_reserve_bundle)
        s.register("release_bundle", self._h_release_bundle)
        # slow lane: _h_request_lease can park ~60s in spawn+ready-wait; a
        # burst of lease requests must not starve the control-plane pool
        s.register("request_lease", self._h_request_lease, slow=True)
        s.register("return_lease", self._h_return_lease)
        s.register("renew_leases", self._h_renew_leases, oneway=True)
        s.register("lease_demand", self._h_lease_demand, oneway=True)
        s.register("node_info", self._h_node_info)
        # slow lane: fans out to every worker on the node
        s.register("list_node_objects", self._h_list_node_objects, slow=True)
        s.register("node_metrics", self._h_node_metrics, slow=True)
        # profiler plane: capture blocks for its window + worker fan-out;
        # cpu stats fan out to every worker's attribution table
        s.register("profile_capture", self._h_profile_capture, slow=True)
        s.register("node_cpu_stats", self._h_node_cpu_stats, slow=True)
        s.register("list_logs", self._h_list_logs)
        s.register("tail_log", self._h_tail_log)
        # structured-log query: scans this node's JSONL log dir with
        # filters; a big dir costs bounded tail reads, but it is still
        # file I/O — slow lane so a log sweep never starves dispatch
        s.register("log_query", self._h_log_query, slow=True)
        s.register("node_stats", self._h_node_stats)
        s.register("explain_task", self._h_explain_task)
        s.register("ping", lambda m, f: "pong")

        self._threads = [
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="nodelet-heartbeat"),
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="nodelet-dispatch"),
            threading.Thread(target=self._reap_loop, daemon=True,
                             name="nodelet-reaper"),
        ]

    # ------------------------------------------------------------ lifecycle

    def start(self):
        self.server.start()
        self.client.call(self.head_address, "register_node", {
            "node": {
                "node_id": self.node_id,
                "address": self.address,
                "resources": self.resources,
                "labels": self.labels,
                "store_name": self.store.name,
            }
        }, timeout=30, retries=3)
        for t in self._threads:
            t.start()
        # prestart warm workers (reference: WorkerPool prestart,
        # worker_pool.h:216) — they register idle via worker_ready
        n_prestart = cfg.get("PRESTART_WORKERS")
        for _ in range(min(n_prestart, self._max_task_workers)):
            self._spawn_worker()
        return self

    def stop(self):
        # set under the lock that registers a spawned worker: a spawn
        # racing this stop either lands in the list below or sees the
        # flag and stops its own process (_spawn_worker)
        with self._lock:
            self._stopped.set()
            workers = list(self._workers.values())
        self._dispatch_wake.set()
        for w in workers:
            try:
                w.proc.terminate()
            except Exception:
                pass
        for w in workers:
            _stop_process(w.proc, grace_s=2)
        self.server.stop()
        # Unlink the shm NAME but keep this process's mapping alive:
        # server.stop() does not drain in-flight handler threads (slow-
        # lane handlers can park for seconds), so a queued free_object /
        # fetch_object may still touch the store — unmapping under it is
        # a process SIGSEGV (observed in the r4 soak). Pages are freed
        # when the last mapping drops (process exit for in-process test
        # nodelets; 64MB-class test segments make that affordable).
        self.store.unlink()

    # ------------------------------------------------------------ logs
    # Log streaming (reference: the dashboard log monitor,
    # python/ray/_private/log_monitor.py:103 — per-node agent tails
    # worker logs for the dashboard/CLI; here the nodelet serves them).

    def _h_node_stats(self, msg, frames):
        """Per-node agent stats (reference: dashboard/agent.py — the
        per-node tier collecting process/host stats for the dashboard;
        here the nodelet IS the agent, so the stats ride its RPC server
        instead of a separate process)."""
        def rss_kb(pid: int) -> int:
            try:
                with open(f"/proc/{pid}/statm") as f:
                    return int(f.read().split()[1]) * \
                        (os.sysconf("SC_PAGE_SIZE") // 1024)
            except (OSError, ValueError, IndexError):
                return 0

        with self._lock:
            workers = [
                {"worker_id": w.worker_id.hex(),
                 "pid": getattr(w.proc, "pid", None),
                 "ready_s": w.ready_s,
                 "idle": w.idle,
                 "actor_id": w.actor_id.hex() if w.actor_id else None}
                for w in self._workers.values()
            ]
            avail = dict(self._available)
            qlen = len(self._queue)
        # /proc reads stay OFF the lock: one stall (e.g. a pid being
        # reaped) must not hold up dispatch
        for rec in workers:
            rec["rss_kb"] = rss_kb(rec["pid"] or 0)
        try:
            load1, load5, load15 = os.getloadavg()
        except OSError:
            load1 = load5 = load15 = 0.0
        return {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "loadavg": [load1, load5, load15],
            "num_workers": len(workers),
            "workers": workers,
            "queue_len": qlen,
            "resources": dict(self.resources),
            "available": avail,
            "store": self.store.stats(),
            # per-method handler/queue-lag stats (reference:
            # common/event_stats.h — the event-loop instrumentation)
            "event_stats": self.server.event_stats(),
        }

    def _h_list_logs(self, msg, frames):
        out = []
        try:
            for name in sorted(os.listdir(self.log_dir)):
                path = os.path.join(self.log_dir, name)
                if os.path.isfile(path):
                    out.append({"file": name,
                                "size": os.path.getsize(path)})
        except OSError:
            pass
        return {"logs": out}

    def _h_tail_log(self, msg, frames):
        """Tail a log file. `offset` (-1 = from the end minus nbytes)
        enables incremental follow — the caller passes the returned
        `end_offset` back to stream only new bytes."""
        name = os.path.basename(msg["file"])  # no path traversal
        path = os.path.join(self.log_dir, name)
        nbytes = int(msg.get("nbytes", 64 * 1024))
        offset = int(msg.get("offset", -1))
        try:
            size = os.path.getsize(path)
            start = max(0, size - nbytes) if offset < 0 else min(offset, size)
            with open(path, "rb") as f:
                f.seek(start)
                data = f.read(nbytes)
            return {"ok": True, "end_offset": start + len(data),
                    "size": size}, [data]
        except OSError as e:
            return {"ok": False, "error": str(e)}

    def _h_log_query(self, msg, frames):
        """Filtered query over this node's STRUCTURED logs (the JSONL
        files every process on this node writes via
        utils/logging.py): tail/grep/level/time-window/trace-id/task-id
        filters, bounded reply, per-file byte offsets for incremental
        follow. Records are filtered to THIS node's origin by default,
        so in-process test clusters sharing one log dir never
        double-report a record through two nodelets."""
        from ray_tpu_torch.utils import logging as slog

        return slog.query_log_dir(
            self.log_dir,
            level=msg.get("level"),
            grep=msg.get("grep"),
            since=msg.get("since"),
            until=msg.get("until"),
            trace_id=msg.get("trace_id"),
            task=msg.get("task"),
            proc=msg.get("proc"),
            limit=msg.get("limit") or 1000,
            offsets=msg.get("offsets"),
            node=None if msg.get("any_node")
            else self.node_id.hex()[:12])

    def _h_lease_demand(self, msg, frames):
        owner = msg.get("owner")
        count = int(msg.get("count", 0))
        with self._lock:
            if count <= 0:
                self._lease_demand.pop(owner, None)
            else:
                self._lease_demand[owner] = (time.monotonic() + 2.0, count)

    def _heartbeat_loop(self):
        """Liveness beats every interval; the resource PAYLOAD rides only
        when it changed (or every 5th beat as an anti-entropy refresh) —
        the delta-sync idea of the reference's ray_syncer
        (src/ray/common/ray_syncer/ray_syncer.h:83: only changed
        components are broadcast), without the bidi-stream machinery."""
        last_sent = None
        beats_since_full = 0
        while not self._stopped.wait(HEARTBEAT_INTERVAL_S):
            now = time.monotonic()
            with self._lock:
                avail = dict(self._available)
                for o in [o for o, (exp, _) in self._lease_demand.items()
                          if exp < now]:
                    self._lease_demand.pop(o, None)
                qlen = len(self._queue) + sum(
                    c for _, c in self._lease_demand.values())
                qdemand = dict(self._queued_demand)
            snapshot = (avail, qlen, qdemand)
            beats_since_full += 1
            msg = {"node_id": self.node_id}
            carries_payload = (snapshot != last_sent
                               or beats_since_full >= 5)
            if carries_payload:
                msg["available"] = avail
                msg["queue_len"] = qlen
                # demand SHAPES (aggregate over queued tasks) — the v1
                # autoscaler's demand scheduler bin-packs these onto
                # node types (reference: resource_demand_scheduler.py
                # reads load_metrics resource_load_by_shape)
                msg["queued_demand"] = qdemand
            try:
                self.client.send_oneway(self.head_address, "heartbeat", msg)
            except Exception:
                continue  # don't mark the payload delivered
            if carries_payload:
                # commit AFTER the send attempt: a dropped payload beat
                # must retry next interval, not go silent until the
                # anti-entropy refresh
                last_sent = snapshot
                beats_since_full = 0
            self._flush_ledger_events()

    def _ledger_event(self, spec: TaskSpec, state: str,
                      verdict: dict | None = None,
                      detail: str | None = None):
        """Queue one scheduler-side lifecycle transition for the head
        ledger (flushed by the heartbeat loop over the task_events
        oneway lane)."""
        ev = {"task_id": spec.task_id.hex(), "name": spec.name,
              "state": state, "type": "NORMAL_TASK",
              "trace_id": (spec.trace or {}).get("trace_id", ""),
              "node_id": self.node_id.hex(), "time": time.time()}
        if verdict is not None:
            ev["verdict"] = verdict
        if detail:
            ev["detail"] = detail
        with self._lock:
            if len(self._ledger_buf) >= 2000:
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
        except Exception:
            # local send failure: these are observability events — drop
            # the batch (counted) rather than grow an unbounded retry pile
            with self._lock:
                self._ledger_drops += len(batch)

    # ------------------------------------------------------------ workers

    def _spawn_worker(self, gpu: bool = False,
                      runtime_env: dict | None = None,
                      lease_id: bytes | None = None,
                      claims: dict | None = None) -> _Worker:
        from ray_tpu_torch.core.ids import WorkerID

        wid = WorkerID.random().binary()
        env = dict(os.environ)
        cwd = None
        py_exe = None
        ehash = rtenv.env_hash(runtime_env)
        if runtime_env:
            extra, cwd, py_exe = rtenv.materialize(
                runtime_env, self.session_dir, self.client,
                self.head_address)
            env.update(extra)
        # the worker imports ray_tpu_torch from the checkout this nodelet
        # runs from, whatever the launch cwd (a working_dir's included)
        # and whatever its interpreter (a pip/uv env's included)
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        prev = env.get("PYTHONPATH", "")
        if pkg_root not in prev.split(os.pathsep):
            env["PYTHONPATH"] = prev + (os.pathsep if prev else "") + \
                pkg_root
        env["RAY_TPU_NODELET_ADDR"] = self.address
        env["RAY_TPU_HEAD_ADDR"] = self.head_address
        env["RAY_TPU_STORE_NAME"] = self.store.name
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_WORKER_ID"] = wid.hex()
        env["RAY_TPU_SESSION_DIR"] = self.session_dir
        # orphan check: the worker exits once this process is gone
        env["RAY_TPU_NODELET_PID"] = str(os.getpid())
        # device visibility handoff through the accelerator plugin
        # registry (reference: AcceleratorManager.set_*_visible_devices,
        # _private/accelerators/) — a worker claiming the accelerator
        # resource gets the device handed through; others get it hidden
        from ray_tpu_torch import accelerators as _acc

        claims = dict(claims or {})
        if gpu:
            claims.setdefault("GPU", 1.0)
        for mgr in _acc.all_managers().values():
            mgr.configure_worker_env(
                env, claimed=claims.get(mgr.resource_name, 0) > 0)
        log = open(os.path.join(self.log_dir, f"worker-{wid.hex()[:12]}.log"), "ab")
        try:
            proc = subprocess.Popen(
                [py_exe or sys.executable, "-m",
                 "ray_tpu_torch.core.worker_main"],
                env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True, cwd=cwd,
            )
        finally:
            log.close()  # the child holds its own descriptor
        w = _Worker(wid, proc, gpu=gpu, env_hash=ehash)
        # leased-at-birth: set BEFORE registration so a worker_ready racing
        # this return can't park the worker in the idle pool where another
        # lease request would double-grant it
        w.lease_id = lease_id
        with self._lock:
            stopped = self._stopped.is_set()
            if not stopped:
                self._workers[wid] = w
        if stopped:
            # stop() has taken its list of workers: this one would
            # outlive the node, so it goes now
            _stop_process(proc, grace_s=0)
            raise RuntimeError("nodelet stopped")
        return w

    def _h_worker_ready(self, msg, frames):
        with self._lock:
            w = self._workers.get(msg["worker_id"])
            if w is None:
                return {}
            w.address = msg["address"]
            if w.ready_s is None:
                w.ready_s = time.monotonic() - w.spawned_at
            w.ready.set()
            if w.actor_id is None and not w.idle and \
                    w.current_task is None and w.lease_id is None:
                w.idle = True
                self._idle_workers.append(w)
        self._dispatch_wake.set()
        return {}

    # ------------------------------------------------------------ leases
    # Worker-lease reuse (reference: NormalTaskSubmitter::OnWorkerIdle
    # lease caching, core_worker/transport/normal_task_submitter.cc:137):
    # a submitter leases a worker once, then pushes repeated same-shape
    # tasks DIRECTLY to it — no per-task scheduling hop. The lease holds
    # the task's resources until returned, TTL-expired (owner died), or
    # the worker dies (owner gets lease_broken and resubmits).

    def _h_request_lease(self, msg, frames):
        resources = dict(msg.get("resources") or {})
        runtime_env = msg.get("runtime_env")
        needs_gpu = resources.get("GPU", 0) > 0
        want_env = rtenv.env_hash(runtime_env)
        lease_id = os.urandom(8)
        with self._lock:
            can_run = self._can_run(resources)
        if not can_run:
            # lease spillback: point the submitter at the best other node
            # (reference: raylet replies with a spillback node in
            # RequestWorkerLease, local_task_manager spillback). View RPC
            # happens OFF the nodelet lock.
            best = self._best_fit_node(resources,
                                       self._cluster_view_cached(),
                                       exclude_node_id=self.node_id)
            if best is not None:
                return {"granted": False, "reason": "no-capacity",
                        "spill": best["address"]}
            return {"granted": False, "reason": "no-capacity"}
        with self._lock:
            if not self._can_run(resources):
                return {"granted": False, "reason": "no-capacity"}
            w = None
            for cand in list(self._idle_workers):
                if cand.worker_id in self._workers and \
                        cand.gpu == needs_gpu and cand.env_hash == want_env:
                    w = cand
                    self._idle_workers.remove(cand)
                    break
            if w is None:
                n_task_workers = sum(1 for x in self._workers.values()
                                     if x.actor_id is None)
                if n_task_workers + self._pending_spawns >= \
                        self._max_task_workers:
                    # capped: any idle worker has the wrong env/device
                    # shape — evict one to make room (same policy as the
                    # classic dispatch path; reference: runtime-env-keyed
                    # worker eviction, worker_pool.h). If all are busy,
                    # refuse and let the submitter back off.
                    victim = None
                    for cand in list(self._idle_workers):
                        if cand.worker_id in self._workers:
                            victim = cand
                            self._idle_workers.remove(cand)
                            victim.idle = False  # reap loop polls it
                            break
                    if victim is None:
                        return {"granted": False, "reason": "worker-cap"}
                    try:
                        victim.proc.terminate()
                    except Exception:  # noqa: BLE001
                        pass
                # reserve the pool slot inside THIS lock hold: the worker
                # only appears in _workers after the spawn completes, so
                # racing requests would all pass the cap check otherwise
                self._pending_spawns += 1
            # acquire before the (slow) spawn so racing submitters spill
            for r, q in resources.items():
                self._available[r] = _fpq(self._available[r] - q)
            if w is not None:
                w.idle = False
                w.lease_id = lease_id  # claim inside THIS lock hold
        def _rollback():
            with self._lock:
                for r, q in resources.items():
                    self._available[r] = min(self.resources.get(r, 0.0),
                                             _fpq(self._available[r] + q))
        if w is None:
            try:
                w = self._spawn_worker(gpu=needs_gpu, runtime_env=runtime_env,
                                       lease_id=lease_id,
                                       claims=resources)
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._pending_spawns -= 1
                _rollback()
                return {"granted": False, "reason": f"spawn failed: {e}"}
            with self._lock:
                self._pending_spawns -= 1
        def _ungrant():
            # the worker stays in the pool: put it back on the idle list
            # (a reused worker gets no second worker_ready, so without
            # this it would leak a pool slot forever — capped refusals
            # with zero running work)
            with self._lock:
                w.lease_id = None
                if w.worker_id in self._workers and w.actor_id is None \
                        and w.current_task is None and not w.idle \
                        and w.ready.is_set():
                    w.idle = True
                    self._idle_workers.append(w)
            _rollback()
            self._dispatch_wake.set()

        if not w.ready.wait(timeout=60):
            _ungrant()
            return {"granted": False, "reason": "worker-start-timeout"}
        # tell the worker its live lease id BEFORE the grant returns, so
        # it can reject direct pushes carrying a stale/expired lease
        try:
            self.client.call(w.address, "set_lease",
                             {"lease_id": lease_id}, timeout=10)
        except Exception:  # noqa: BLE001
            _ungrant()
            return {"granted": False, "reason": "worker-unreachable"}
        with self._lock:
            w.acquired = dict(resources)
            w.assigned_time = time.monotonic()
            self._leases[lease_id] = _Lease(
                lease_id, w, msg.get("owner"), resources,
                time.monotonic() + LEASE_TTL_S)
        return {"granted": True, "lease_id": lease_id,
                "worker_id": w.worker_id, "address": w.address}

    def _h_return_lease(self, msg, frames):
        self._end_lease(msg["lease_id"], back_to_idle=True)
        return {"ok": True}

    def _h_renew_leases(self, msg, frames):
        now = time.monotonic()
        with self._lock:
            for lid in msg.get("lease_ids", ()):
                lease = self._leases.get(lid)
                if lease is not None:
                    lease.expiry = now + LEASE_TTL_S

    def _end_lease(self, lease_id: bytes, back_to_idle: bool,
                   notify_owner: bool = False, reason: str = ""):
        with self._lock:
            lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        w = lease.worker
        with self._lock:
            w.lease_id = None
            addr = w.address
        # tell the worker the lease died so it rejects stale direct pushes
        # (keyed clear: a racing re-grant's set_lease is never clobbered)
        if addr:
            try:
                self.client.send_oneway(addr, "set_lease",
                                        {"clear": lease_id})
            except Exception:  # noqa: BLE001
                pass
        # TTL expiry means the owner stopped renewing OR its renew oneways
        # were lost; in the second case it still believes the lease is live
        # and its enqueue-acked in-flight pushes would hang forever without
        # this notification (they are past ack-sweeper coverage)
        if notify_owner and lease.owner:
            try:
                self.client.send_oneway(lease.owner, "lease_broken", {
                    "lease_id": lease_id,
                    "worker_id": w.worker_id,
                    "reason": reason,
                })
            except Exception:  # noqa: BLE001
                pass
        self._release_worker_resources(w)
        if back_to_idle:
            with self._lock:
                if w.worker_id in self._workers and w.actor_id is None and \
                        not w.idle:
                    w.idle = True
                    self._idle_workers.append(w)
        self._dispatch_wake.set()

    def _expire_leases(self):
        now = time.monotonic()
        with self._lock:
            stale = [lid for lid, le in self._leases.items()
                     if le.expiry < now]
        for lid in stale:
            self._end_lease(lid, back_to_idle=True, notify_owner=True,
                            reason="lease TTL expired")

    def _reap_loop(self):
        """Detect worker-process death (reference: raylet learns of worker
        death via socket disconnect; here we poll child processes)."""
        while not self._stopped.wait(0.2):
            dead = []
            with self._lock:
                for w in self._workers.values():
                    if w.proc.poll() is not None:
                        dead.append(w)
                for w in dead:
                    self._workers.pop(w.worker_id, None)
                    if w in self._idle_workers:
                        self._idle_workers.remove(w)
            for w in dead:
                self._on_worker_death(w)
            self._expire_leases()
            self._check_memory_pressure()

    # ------------------------------------------------------------ OOM killer
    # Reference: memory_monitor.h:52 node-RSS sampling + the shipped
    # worker-killing policies (worker_killing_policy.h:34). Without this
    # a host-RAM-hungry job takes the whole nodelet (and node) with it.

    def _check_memory_pressure(self):
        from ray_tpu_torch.core import oom

        refresh_ms = cfg.get("MEMORY_MONITOR_REFRESH_MS")
        if refresh_ms <= 0:
            return
        now = time.monotonic()
        if now - self._last_memory_check < refresh_ms / 1000.0:
            return
        self._last_memory_check = now
        snap = oom.take_snapshot()
        if not oom.is_above_threshold(snap, cfg.get("MEMORY_USAGE_THRESHOLD"),
                                      cfg.get("MIN_MEMORY_FREE_BYTES")):
            return
        candidates = []
        with self._lock:
            lease_by_worker = {le.worker.worker_id: le
                               for le in self._leases.values()}
            for w in self._workers.values():
                if w.oom_kill_retry is not None:
                    return  # a kill is already in flight; wait for reap
                cand = None
                if w.current_task is not None:
                    spec = w.current_task
                    cand = oom.KillCandidate(
                        w, spec.owner, spec.max_retries != 0,
                        w.assigned_time)
                elif w.worker_id in lease_by_worker:
                    le = lease_by_worker[w.worker_id]
                    # leased pushes are owner-resubmitted via lease_broken
                    cand = oom.KillCandidate(w, le.owner or "", True,
                                             w.assigned_time)
                elif w.actor_id is not None and w.oom_meta is not None:
                    owner, restartable = w.oom_meta
                    cand = oom.KillCandidate(w, owner, restartable,
                                             w.assigned_time)
                if cand is not None:
                    candidates.append(cand)
        # per-candidate /proc reads happen off the lock — a slow or
        # vanishing /proc entry must not stall dispatch
        for cand in candidates:
            cand.rss_bytes = oom.process_rss_bytes(cand.worker.proc.pid)
        victim, should_retry = oom.select_worker_to_kill(
            candidates, cfg.get("WORKER_KILLING_POLICY"))
        if victim is None:
            return
        w = victim.worker
        with self._lock:
            w.oom_kill_retry = bool(should_retry)
            self._oom_kills += 1
        _log.warning(
            "memory pressure: %.1f%% used (threshold %.0f%%); killing "
            "worker %s (rss=%dMB, policy=%s, retry=%s)",
            snap.used_fraction * 100,
            cfg.get("MEMORY_USAGE_THRESHOLD") * 100,
            w.worker_id.hex()[:8], victim.rss_bytes >> 20,
            cfg.get("WORKER_KILLING_POLICY"), should_retry)
        try:
            w.proc.kill()
        except Exception:  # noqa: BLE001
            pass

    def _on_worker_death(self, w: _Worker):
        rc = w.proc.returncode
        self._release_worker_resources(w)
        # atomically take current_task: _requeue_or_fail (push timeout path)
        # and this reap path must not BOTH report a retryable failure, or
        # the owner resubmits twice and the task runs twice
        with self._lock:
            spec, w.current_task = w.current_task, None
            oom_retry = w.oom_kill_retry
        if spec is not None:
            if oom_retry is not None:
                err, retryable = _oom_killed_error(spec.name), bool(oom_retry)
            else:
                err, retryable = _worker_died_error(spec.name, rc), True
            try:
                self.client.send_oneway(spec.owner, "task_done", {
                    "task_id": spec.task_id,
                    "oids": spec.return_oids,
                    "error": ser.dumps_msg(err),
                    "retryable": retryable,
                })
            except Exception:
                pass
        if w.actor_id is not None and not self._stopped.is_set():
            cause = ("killed by the node memory monitor (OOM)"
                     if oom_retry is not None
                     else f"worker process exited (code {rc})")
            try:
                self.client.call(self.head_address, "actor_died",
                                 {"actor_id": w.actor_id,
                                  "cause": cause},
                                 timeout=10)
            except Exception:
                pass
        if w.lease_id is not None:
            # leased worker died: the owner tracks its own in-flight pushes
            # and resubmits them through the classic scheduling path
            with self._lock:
                lease = self._leases.pop(w.lease_id, None)
                w.lease_id = None
            if lease is not None and lease.owner:
                try:
                    self.client.send_oneway(lease.owner, "lease_broken", {
                        "lease_id": lease.lease_id,
                        "worker_id": w.worker_id,
                        "rc": rc,
                    })
                except Exception:
                    pass
        self._dispatch_wake.set()

    def _release_worker_resources(self, w: _Worker):
        with self._lock:
            acquired, w.acquired = w.acquired, {}
            for r, q in acquired.items():
                self._available[r] = min(self.resources.get(r, 0.0),
                                         _fpq(self._available.get(r, 0.0) + q))
            bundle, w.bundle = w.bundle, None
            if bundle is not None:
                key, res = bundle
                free = self._bundle_free.get(key)
                cap = self._bundles.get(key)
                if free is not None and cap is not None:
                    for r, q in res.items():
                        free[r] = min(cap.get(r, 0.0),
                                      free.get(r, 0.0) + q)

    def _fail_task(self, spec: TaskSpec, cause: str,
                   retryable: bool = False):
        self._ledger_event(spec, "FAILED", detail=cause)
        try:
            self.client.send_oneway(spec.owner, "task_done", {
                "task_id": spec.task_id,
                "oids": spec.return_oids,
                "error": ser.dumps_msg(ValueError(cause)),
                "retryable": retryable,
            })
        except Exception:
            pass

    # ------------------------------------------------------------ scheduling

    def _h_schedule_tasks(self, msg, frames):
        """Batched plain-task submission — the submit coalescer's frame:
        one dispatch runs N schedule_task placement decisions (dedup,
        local queue, or spillback each, exactly like the singleton
        handler)."""
        return {"queued": [self._h_schedule_task({"spec": s}, ())["queued"]
                           for s in msg["specs"]]}

    def _h_schedule_task(self, msg, frames):
        spec = TaskSpec(**msg["spec"])
        # dedup at-least-once deliveries (submitter retries on slow reply)
        key = (spec.task_id, spec.attempt, spec.spillback_count)
        with self._lock:
            if key in self._seen_tasks:
                return {"queued": "duplicate"}
            self._seen_tasks.add(key)
            self._seen_tasks_order.append(key)
            while len(self._seen_tasks_order) > 20000:
                self._seen_tasks.discard(self._seen_tasks_order.popleft())
        target = self._place(spec)
        if target == "local":
            with self._lock:
                self._queue.append(spec)
                self._add_queued_demand(spec, +1)
                self._enqueue_time[spec.task_id] = time.monotonic()
            self._ledger_event(spec, "QUEUED", verdict={
                "decision": "local", "node_id": self.node_id.hex()[:12]})
            self._dispatch_wake.set()
            return {"queued": "local"}
        if target is None:
            # scheduler decision tracing: an infeasible-wait verdict
            # records WHY — which nodes were considered and which
            # constraint failed — so `ray_tpu explain` can name the
            # unsatisfiable requirement instead of showing a stuck task
            from ray_tpu_torch.util.scheduling_strategies import (
                split_soft_selector as _sss2,
            )

            sel2, _ = _sss2(spec.label_selector)
            considered, constraint = self._consider_nodes(
                self._task_req(spec), sel2 or None)
            with self._lock:  # queue anyway; resources may appear
                self._queue.append(spec)
                self._add_queued_demand(spec, +1)
                self._enqueue_time[spec.task_id] = time.monotonic()
            self._ledger_event(spec, "QUEUED", verdict={
                "decision": "infeasible-wait",
                "node_id": self.node_id.hex()[:12],
                "constraint": constraint or "waiting for resources",
                "nodes_considered": considered,
                "spillback_count": spec.spillback_count})
            self._dispatch_wake.set()
            return {"queued": "infeasible-wait"}
        # spillback (reference: normal_task_submitter.cc:451 retry at
        # the raylet the scheduler pointed to)
        spec.spillback_count += 1
        self._ledger_event(spec, "SCHEDULED",
                           detail=f"spillback to {target}")
        self.client.call(target, "schedule_task",
                         {"spec": dataclass_dict(spec)}, timeout=30)
        return {"queued": "spilled"}

    def _place(self, spec: TaskSpec):
        """'local', a remote nodelet address, or None (nothing fits)."""
        req = spec.resources
        with self._lock:
            if spec.placement_group is not None:
                # PG tasks were routed here by the owner via pg_bundle_node;
                # run them against the reservation.
                return "local"
        from ray_tpu_torch.util.scheduling_strategies import (
            labels_match,
            split_soft_selector,
        )

        sel, soft_sel = split_soft_selector(spec.label_selector)
        if sel and not labels_match(self.labels, sel):
            # label-constrained task on a non-matching node: route to a
            # matching node (reference: label scheduling / node affinity,
            # node_affinity_scheduling_policy.h:29). Hard selectors wait
            # when no match exists; soft selectors fall back to the
            # normal placement path below.
            best = self._best_fit_node(req, self._cluster_view_cached(),
                                       exclude_node_id=self.node_id,
                                       selector=sel)
            if best is not None:
                return best["address"]
            if not soft_sel:
                return None  # infeasible-wait: dispatch guard holds it
        with self._lock:
            fits_total = all(self.resources.get(r, 0.0) >= q
                             for r, q in req.items())
            fits_now = all(
                self._available.get(r, 0.0) -
                self._queued_demand.get(r, 0.0) >= q
                for r, q in req.items())
            queue_len = len(self._queue)
        if fits_now or (fits_total and queue_len < 2) or \
                spec.spillback_count >= cfg.get("MAX_SPILLBACKS"):
            return "local" if fits_total or spec.placement_group else None
        # look for a better node — honoring the task's selector, so a
        # hard-label task on a matching-but-busy node never bounces to a
        # non-matching one
        best = self._best_fit_node(req, self._cluster_view_cached(),
                                   exclude_node_id=self.node_id,
                                   selector=sel or None)
        if best is not None:
            return best["address"]
        return "local" if fits_total else None

    def _cluster_view_cached(self):
        now = time.monotonic()
        with self._lock:
            view, ts = self._cluster_view, self._view_ts
        if now - ts <= 1.0:
            return view
        # the view RPC stays OFF the lock: dispatch + handler threads
        # race here and the loser's slightly-staler view is harmless
        try:
            resp = self.client.call(self.head_address, "cluster_view", {},
                                    timeout=5)
        except Exception:
            return view
        with self._lock:
            self._cluster_view = resp["nodes"]
            self._view_ts = now
            return self._cluster_view

    def _add_queued_demand(self, spec: TaskSpec, sign: int):
        """Caller holds self._lock (every enqueue/dequeue site does)."""
        if spec.placement_group is not None:
            return  # PG tasks are metered against their bundle
        for r, q in spec.resources.items():
            v = self._queued_demand.get(r, 0.0) + sign * q
            if v <= 1e-9:
                self._queued_demand.pop(r, None)
            else:
                self._queued_demand[r] = v

    @staticmethod
    def _best_fit_node(req: dict, view: list, exclude_node_id=None,
                       selector: dict | None = None):
        """Feasible node with the most free capacity (shared by initial
        placement and aged-task respill); `selector` restricts to
        label-matching nodes."""
        from ray_tpu_torch.util.scheduling_strategies import labels_match

        best, best_free = None, None
        for n in view:
            if n["node_id"] == exclude_node_id or not n.get("alive"):
                continue
            if selector and not labels_match(n.get("labels", {}), selector):
                continue
            total, avail = n["resources"], n["available"]
            if any(total.get(r, 0.0) < q for r, q in req.items()):
                continue
            if any(avail.get(r, 0.0) < q for r, q in req.items()):
                continue
            free = sum(avail.values())
            if best_free is None or free > best_free:
                best, best_free = n, free
        return best

    def _consider_nodes(self, req: dict, selector: dict | None):
        """Per-node feasibility table for scheduler decision tracing:
        why each cluster node can or cannot take this request right
        now. Returns (entries, constraint) — `constraint` names the
        unsatisfiable requirement when NO node can EVER satisfy it
        (label mismatch everywhere / total capacity short everywhere),
        None when the request is merely waiting on busy resources."""
        from ray_tpu_torch.util.scheduling_strategies import labels_match

        view = self._cluster_view_cached()
        entries = []
        any_label_match = False
        any_total_fit = False
        for n in view:
            nid = n["node_id"]
            e = {"node_id": (nid.hex() if hasattr(nid, "hex")
                             else str(nid))[:12], "ok": False}
            if not n.get("alive", True):
                e["reason"] = "dead"
                entries.append(e)
                continue
            if selector and not labels_match(n.get("labels", {}), selector):
                e["reason"] = (f"label selector {selector} does not match "
                               f"node labels")
                entries.append(e)
                continue
            any_label_match = True
            total = n.get("resources", {})
            avail = n.get("available", {})
            short = {r: q for r, q in req.items()
                     if total.get(r, 0.0) < q}
            if short:
                e["reason"] = (
                    f"insufficient total capacity: needs {short}, node "
                    f"has {({r: total.get(r, 0.0) for r in short})}")
                entries.append(e)
                continue
            any_total_fit = True
            busy = {r: q for r, q in req.items()
                    if avail.get(r, 0.0) < q}
            if busy:
                e["reason"] = (
                    f"busy: needs {busy}, only "
                    f"{({r: avail.get(r, 0.0) for r in busy})} available")
            else:
                e["ok"] = True
                e["reason"] = "feasible"
            entries.append(e)
        constraint = None
        if selector and not any_label_match:
            constraint = (f"no alive node matches hard label selector "
                          f"{selector}")
        elif not any_total_fit:
            constraint = (f"no node in the cluster has total capacity "
                          f"for resources {req}")
        return entries, constraint

    def _h_explain_task(self, msg, frames):
        """Live half of `ray_tpu explain`: is the task queued on THIS
        node, how long has it waited, and what does placement look like
        against the current cluster view. The head fans this out to
        every alive nodelet under one shared deadline."""
        p = str(msg.get("task_id") or "").lower()
        with self._lock:
            qspecs = list(self._queue)
            enq = dict(self._enqueue_time)
            avail = dict(self._available)
        spec = pos = None
        for i, s in enumerate(qspecs):
            if p and s.task_id.hex().startswith(p):
                spec, pos = s, i
                break
        out = {"node_id": self.node_id.hex()[:12],
               "queued": spec is not None, "queue_len": len(qspecs)}
        if spec is None:
            return out
        t0 = enq.get(spec.task_id)
        out.update({
            "name": spec.name,
            "queue_position": pos,
            "waited_s": (round(time.monotonic() - t0, 3)
                         if t0 is not None else None),
            "resources": spec.resources,
            "label_selector": spec.label_selector,
            "available": avail,
            "spillback_count": spec.spillback_count,
        })
        from ray_tpu_torch.util.scheduling_strategies import split_soft_selector

        sel, _ = split_soft_selector(spec.label_selector)
        considered, constraint = self._consider_nodes(
            self._task_req(spec), sel or None)
        out["nodes_considered"] = considered
        if constraint:
            out["constraint"] = constraint
        return out

    def _maybe_respill_locked(self, spec: TaskSpec):
        """A task that has waited locally while the cluster changed can
        move to a node with free capacity (reference: queued tasks are
        re-scheduled when the cluster resource view changes; here aged
        head-of-queue tasks re-run best-fit). Returns a target address or
        None. Caller holds self._lock."""
        if spec.placement_group is not None:
            return None
        if spec.spillback_count >= cfg.get("MAX_SPILLBACKS"):
            return None
        waited = time.monotonic() - self._enqueue_time.get(
            spec.task_id, time.monotonic())
        if waited < 0.5:
            return None
        from ray_tpu_torch.util.scheduling_strategies import split_soft_selector

        sel, _ = split_soft_selector(spec.label_selector)
        best = self._best_fit_node(
            spec.resources, self._cluster_view,  # refreshed by dispatch
            exclude_node_id=self.node_id, selector=sel or None)
        return best["address"] if best else None

    def _send_respill(self, spec: TaskSpec, target: str):
        spec.spillback_count += 1
        try:
            self.client.call(target, "schedule_task",
                             {"spec": dataclass_dict(spec)}, timeout=30,
                             retries=1)
        except Exception as e:  # noqa: BLE001
            # The send MAY have been delivered (lost reply): requeueing
            # locally would risk double execution outside the dedup path.
            # Report a retryable failure instead — the owner's resubmit
            # carries attempt+1 and flows through the dedup like any
            # other retry.
            self._fail_task(spec, f"respill to {target} failed: {e}",
                            retryable=True)

    def _can_run(self, req: dict) -> bool:
        return all(self._available.get(r, 0.0) >= q for r, q in req.items())

    def _task_req(self, spec: TaskSpec) -> dict:
        if spec.placement_group is not None:
            # PG tasks are metered against their bundle reservation
            # (reference: bundle resources are committed at PG creation;
            # tasks inside the group consume from the bundle, not the
            # node's free pool — gcs_placement_group_manager.h:228).
            return {}
        return spec.resources

    _BUNDLE_REJECT = "reject"

    def _bundle_for(self, spec):
        """Which local bundle a PG task/actor draws from. Returns the
        bundle key, None (bundle full — wait), or _BUNDLE_REJECT (the
        request can NEVER fit the reservation). Caller holds self._lock."""
        pg = spec.placement_group
        req = spec.resources
        if spec.bundle_index >= 0:
            key = (pg, spec.bundle_index)
            total = self._bundles.get(key)
            if total is None:
                return self._BUNDLE_REJECT  # bundle not on this node
            if any(total.get(r, 0.0) < q for r, q in req.items()):
                return self._BUNDLE_REJECT
            free = self._bundle_free[key]
            if all(free.get(r, 0.0) >= q for r, q in req.items()):
                return key
            return None
        feasible = False
        for key, total in self._bundles.items():
            if key[0] != pg:
                continue
            if any(total.get(r, 0.0) < q for r, q in req.items()):
                continue
            feasible = True
            free = self._bundle_free[key]
            if all(free.get(r, 0.0) >= q for r, q in req.items()):
                return key
        return None if feasible else self._BUNDLE_REJECT

    def _acquire_for(self, w: _Worker, req: dict) -> bool:
        with self._lock:
            if not self._can_run(req):
                return False
            for r, q in req.items():
                self._available[r] = _fpq(self._available[r] - q)
            for r, q in req.items():
                w.acquired[r] = w.acquired.get(r, 0.0) + q
            return True

    def _dispatch_loop(self):
        """The dispatch hot loop (reference:
        LocalTaskManager::DispatchScheduledTasksToWorkers,
        local_task_manager.cc:121)."""
        while not self._stopped.is_set():
            self._dispatch_wake.wait(timeout=0.05)
            self._dispatch_wake.clear()
            with self._lock:
                starved = bool(self._queue)
            if starved:
                # keep the cluster view fresh (TTL-limited) so aged tasks
                # can respill to newly-added capacity; this blocks only
                # the dispatch thread, never heartbeats
                self._cluster_view_cached()
            rotated = 0  # label-blocked tasks rotated this pass
            while True:
                reject = None
                reject_msg = None
                respill = None
                with self._lock:
                    if not self._queue:
                        break
                    spec = self._queue[0]
                    req = self._task_req(spec)
                    bundle_key = None
                    if spec.placement_group is not None:
                        bundle_key = self._bundle_for(spec)
                        if bundle_key is None:
                            break  # bundle full: wait for a release
                        if bundle_key == self._BUNDLE_REJECT:
                            self._queue.popleft()
                            self._add_queued_demand(spec, -1)
                            self._enqueue_time.pop(spec.task_id, None)
                            reject = spec
                    if reject is None:
                        from ray_tpu_torch.util.scheduling_strategies import (
                            labels_match as _lm,
                            split_soft_selector as _sss,
                        )

                        sel, soft_sel = _sss(spec.label_selector)
                        label_blocked = bool(sel) and \
                            not _lm(self.labels, sel)
                        if label_blocked or not self._can_run(req):
                            respill = self._maybe_respill_locked(spec)
                            if respill is None:
                                if label_blocked and not soft_sel:
                                    # hard affinity with no matching
                                    # node: never park at the queue head
                                    # (it would starve every task behind
                                    # it) — rotate to the back, and fail
                                    # it once it has waited out the
                                    # timeout (reference: hard-affinity
                                    # placement fails when the node is
                                    # gone)
                                    waited = time.monotonic() - \
                                        self._enqueue_time.get(
                                            spec.task_id,
                                            time.monotonic())
                                    self._queue.popleft()
                                    if waited > cfg.get(
                                            "LABEL_INFEASIBLE_TIMEOUT_S"):
                                        self._add_queued_demand(spec, -1)
                                        self._enqueue_time.pop(
                                            spec.task_id, None)
                                        reject = spec
                                        reject_msg = (
                                            "no alive node matches hard "
                                            f"label selector {sel} after "
                                            "LABEL_INFEASIBLE_TIMEOUT_S")
                                    else:
                                        self._queue.append(spec)
                                        rotated += 1
                                        if rotated >= len(self._queue):
                                            break  # full lap: all blocked
                                        continue
                                elif not self._can_run(req):
                                    break
                                # soft selector, no match anywhere, local
                                # resources free: fall back to local run
                            else:
                                self._queue.popleft()
                                self._add_queued_demand(spec, -1)
                                self._enqueue_time.pop(spec.task_id, None)
                    if reject is None and respill is None:
                        needs_gpu = spec.resources.get("GPU", 0) > 0
                        want_env = rtenv.env_hash(spec.runtime_env)
                        w = None
                        # reuse-first: prefer an idle worker whose device
                        # visibility AND runtime env match (reference:
                        # runtime-env-keyed worker pools, worker_pool.h)
                        for cand in list(self._idle_workers):
                            if cand.worker_id in self._workers and \
                                    cand.gpu == needs_gpu and \
                                    cand.env_hash == want_env:
                                w = cand
                                self._idle_workers.remove(cand)
                                break
                        if w is None:
                            n_task_workers = sum(
                                1 for x in self._workers.values()
                                if x.actor_id is None)
                            if n_task_workers >= self._max_task_workers:
                                # capped. Any idle worker here has the
                                # wrong device visibility — evict one to
                                # make room; if all busy, wait.
                                victim = None
                                for cand in list(self._idle_workers):
                                    if cand.worker_id in self._workers:
                                        victim = cand
                                        self._idle_workers.remove(cand)
                                        # keep it in _workers: the reap
                                        # loop must poll() it or the child
                                        # stays a zombie
                                        victim.idle = False
                                        break
                                if victim is None:
                                    break
                                try:
                                    victim.proc.terminate()
                                except Exception:
                                    pass
                        # acquire BEFORE the (slow) worker spawn so racing
                        # submitters see the true availability and spill
                        for r, q in req.items():
                            self._available[r] = _fpq(self._available[r] - q)
                        if bundle_key is not None:
                            free = self._bundle_free[bundle_key]
                            for r, q in spec.resources.items():
                                free[r] = free.get(r, 0.0) - q
                        self._queue.popleft()
                        self._add_queued_demand(spec, -1)
                        t_enq = self._enqueue_time.pop(spec.task_id, None)
                        if t_enq is not None:
                            # queue-wait attribution: enqueue→dispatch
                            # (feeds the task-queue-stall watchtower rule)
                            self._m_queue_wait.observe(
                                time.monotonic() - t_enq)
                        self._ledger_event(spec, "DISPATCHED")
                if reject is not None:
                    self._fail_task(
                        reject,
                        reject_msg or
                        f"task resources {reject.resources} can never fit "
                        f"its placement-group bundle reservation")
                    continue
                if respill is not None:
                    self._ledger_event(spec, "SCHEDULED",
                                       detail=f"respill to {respill}")
                    threading.Thread(target=self._send_respill,
                                     args=(spec, respill),
                                     daemon=True).start()
                    continue
                if w is None:
                    try:
                        w = self._spawn_worker(gpu=needs_gpu,
                                               runtime_env=spec.runtime_env,
                                               claims=spec.resources)
                    except Exception as e:  # noqa: BLE001
                        # bad runtime env (missing KV blob, corrupt zip,
                        # head unreachable) must not kill the dispatch
                        # thread: fail THIS task, release, keep going
                        with self._lock:
                            for r, q in req.items():
                                self._available[r] = min(
                                    self.resources.get(r, 0.0),
                                    _fpq(self._available[r] + q))
                            if bundle_key is not None:
                                free = self._bundle_free.get(bundle_key)
                                if free is not None:
                                    for r, q in spec.resources.items():
                                        free[r] = free.get(r, 0.0) + q
                        self._fail_task(
                            spec, f"worker environment setup failed: {e}")
                        continue
                with self._lock:
                    for r, q in req.items():
                        w.acquired[r] = w.acquired.get(r, 0.0) + q
                    if bundle_key is not None:
                        w.bundle = (bundle_key, dict(spec.resources))
                w.idle = False
                w.current_task = spec
                w.assigned_time = time.monotonic()
                threading.Thread(target=self._push_task, args=(w, spec),
                                 daemon=True).start()

    def _push_task(self, w: _Worker, spec: TaskSpec):
        if not w.ready.wait(timeout=60):
            self._requeue_or_fail(w, spec, "worker failed to start")
            return
        try:
            self.client.send_oneway(w.address, "execute_task",
                                    {"spec": dataclass_dict(spec)})
        except Exception as e:  # noqa: BLE001
            self._requeue_or_fail(w, spec, f"push failed: {e}")

    def _requeue_or_fail(self, w: _Worker, spec: TaskSpec, cause: str):
        with self._lock:
            taken, w.current_task = w.current_task, None
        if taken is None:
            return  # the reap path already reported this task's failure
        self._release_worker_resources(w)
        try:
            self.client.send_oneway(spec.owner, "task_done", {
                "task_id": spec.task_id,
                "oids": spec.return_oids,
                "error": ser.dumps_msg(RuntimeError(cause)),
                "retryable": True,
            })
        except Exception:
            pass

    def _h_task_finished(self, msg, frames):
        with self._lock:
            w = self._workers.get(msg["worker_id"])
        if w is None:
            return
        self._release_worker_resources(w)
        w.current_task = None
        with self._lock:
            if w.worker_id in self._workers and w.actor_id is None and \
                    not w.idle:
                w.idle = True
                self._idle_workers.append(w)
        self._dispatch_wake.set()

    # ------------------------------------------------------------ actors

    def _h_start_actor(self, msg, frames):
        spec = ActorSpec(**msg["spec"])
        spec.cls_blob = frames[0] if frames else spec.cls_blob
        req = {} if spec.placement_group is not None else spec.resources
        needs_gpu = spec.resources.get("GPU", 0) > 0
        bundle_key = None
        with self._lock:
            # cheap refusal BEFORE the (expensive) process spawn: the head
            # retries placement on refusal, which must not churn processes
            if not self._can_run(req):
                raise RuntimeError(f"insufficient resources for actor: {req}")
            if spec.placement_group is not None and spec.resources:
                bundle_key = self._bundle_for(spec)
                if bundle_key in (None, self._BUNDLE_REJECT):
                    raise RuntimeError(
                        f"actor resources {spec.resources} do not fit the "
                        f"placement-group bundle")
                free = self._bundle_free[bundle_key]
                for r, q in spec.resources.items():
                    free[r] = free.get(r, 0.0) - q
        try:
            w = self._spawn_worker(gpu=needs_gpu,
                                   runtime_env=spec.runtime_env,
                                   claims=spec.resources)
        except Exception:
            # env materialization failed: roll back the bundle decrement
            # or the PG permanently loses capacity on this node
            if bundle_key is not None:
                with self._lock:
                    free = self._bundle_free.get(bundle_key)
                    if free is not None:
                        for r, q in spec.resources.items():
                            free[r] = free.get(r, 0.0) + q
            raise
        if not self._acquire_for(w, req):
            with self._lock:
                self._workers.pop(w.worker_id, None)
                if bundle_key is not None:
                    free = self._bundle_free.get(bundle_key)
                    if free is not None:
                        for r, q in spec.resources.items():
                            free[r] = free.get(r, 0.0) + q
            try:
                w.proc.terminate()
            except Exception:
                pass
            raise RuntimeError(f"insufficient resources for actor: {req}")
        if bundle_key is not None:
            with self._lock:
                w.bundle = (bundle_key, dict(spec.resources))
        w.actor_id = spec.actor_id
        w.assigned_time = time.monotonic()
        # OOM group-by-owner key + restartability for the kill policy
        w.oom_meta = (spec.owner, spec.max_restarts != 0)

        def push():
            if not w.ready.wait(timeout=60):
                try:
                    self.client.call(self.head_address, "actor_died",
                                     {"actor_id": spec.actor_id,
                                      "cause": "actor worker failed to start"},
                                     timeout=10)
                except Exception:
                    pass
                return
            self.client.send_oneway(w.address, "become_actor",
                                    {"spec": dataclass_dict(spec)},
                                    frames=[spec.cls_blob])

        threading.Thread(target=push, daemon=True).start()
        return {"ok": True}

    def _h_stop_actor(self, msg, frames):
        with self._lock:
            target = next((w for w in self._workers.values()
                           if w.actor_id == msg["actor_id"]), None)
        if target is not None:
            try:
                target.proc.terminate()
            except Exception:
                pass
        return {}

    # ------------------------------------------------------------ objects

    # Node-to-node transfers move in bounded chunks so a large object
    # never needs 2x its size in transient buffers on either side
    # (reference: chunked ObjectBufferPool transfers, object_manager.h:117)
    PULL_CHUNK = property(lambda self: cfg.get("PULL_CHUNK_BYTES"))

    def _h_prefetch_object(self, msg, frames):
        """Owner-directed push: the submitter tells the execution node to
        start pulling a large arg BEFORE the task needs it (reference:
        PushManager proactive transfer, object_manager/push_manager.h:30 —
        same effect, initiated as a prefetch on the receiver so the
        existing pull/admission machinery is reused). Best-effort: when
        admission is saturated the prefetch is simply dropped — it must
        never park a server thread (the worker's own pull is the
        fallback)."""
        oid = msg["oid"]
        location = msg.get("location")
        if not location or self.store.contains(oid):
            return
        if not self._pull_sem.acquire(blocking=False):
            return
        try:
            self._fetch_object_admitted(oid, location)
        except Exception:  # noqa: BLE001
            pass
        finally:
            self._pull_sem.release()

    def _h_fetch_object(self, msg, frames):
        """Ensure an object is present in the local store, pulling from
        the node given in `location` if needed (reference: PullManager,
        object_manager/pull_manager.h:52). Admission control bounds
        concurrent inbound transfers so a pull storm cannot oversubscribe
        memory/NIC (pull_manager.h request queue role); the WAITER count
        is also bounded so a fetch storm cannot park every RPC handler
        thread — excess callers get an immediate busy error and fall back
        to their direct-pull path."""
        oid = msg["oid"]
        if self.store.contains(oid):
            return {"ok": True}
        location = msg.get("location")
        if not location:
            return {"ok": False, "error": "no location"}
        with self._lock:
            if self._pull_waiters >= 8:
                return {"ok": False, "error": "pull admission busy"}
            self._pull_waiters += 1
        try:
            if not self._pull_sem.acquire(timeout=60):
                return {"ok": False, "error": "pull admission timeout"}
        finally:
            with self._lock:
                self._pull_waiters -= 1
        try:
            return self._fetch_object_admitted(oid, location)
        finally:
            self._pull_sem.release()

    def _holder_dead(self, location: str) -> bool:
        """The head's view lists the node at `location` as dead: a pull
        from it can only time out, so the caller fails at once and the
        owner's reconstruction starts without that wait."""
        return any(n.get("address") == location and not n.get("alive", True)
                   for n in self._cluster_view_cached())

    def _fetch_object_admitted(self, oid, location):
        if self.store.contains(oid):
            return {"ok": True}
        if self._holder_dead(location):
            return {"ok": False, "error": "holder node dead",
                    "holder_dead": True}
        t_fetch0 = time.monotonic()
        meta = self.client.call(location, "object_meta", {"oid": oid},
                                timeout=15, retries=1)
        if not meta.get("ok"):
            return {"ok": False, "error": meta.get("error", "meta failed")}
        size = meta["size"]
        try:
            buf = self.store.create(oid, size)
        except KeyError:
            return {"ok": True}  # concurrent fetch won
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"create failed: {e}"}
        try:
            off = 0
            while off < size:
                n = min(self.PULL_CHUNK, size - off)
                value, frames_in = self.client.call_frames(
                    location, "pull_chunk",
                    {"oid": oid, "offset": off, "size": n},
                    timeout=30, retries=1)
                if not value.get("ok"):
                    raise RuntimeError(value.get("error", "pull failed"))
                buf[off:off + n] = frames_in[0]
                off += n
                with self._lock:
                    self._pull_chunks_served += 1
        except Exception as e:  # noqa: BLE001
            del buf
            try:
                # delete WITHOUT sealing: sealing a half-written buffer
                # would publish corrupt bytes to concurrent readers;
                # rts_delete frees unsealed entries directly
                self.store.delete(oid)
            except Exception:
                pass
            return {"ok": False, "error": str(e)}
        del buf
        self.store.seal(oid)
        # pulled copies are secondary: drop the creator pin so they are
        # LRU-evictable (the primary stays pinned on the owner's node)
        self.store.release(oid)
        self._m_pull_bytes.inc(size)
        self._m_pull_seconds.observe(time.monotonic() - t_fetch0)
        return {"ok": True}

    def _h_object_meta(self, msg, frames):
        oid = msg["oid"]
        v = self.store.get(oid)
        if v is None:
            return {"ok": False, "error": "absent"}
        try:
            return {"ok": True, "size": v.nbytes}
        finally:
            del v
            self.store.release(oid)

    def _h_pull_chunk(self, msg, frames):
        oid = msg["oid"]
        v = self.store.get(oid)
        if v is None:
            return {"ok": False, "error": "absent"}
        try:
            off, n = msg["offset"], msg["size"]
            self._m_push_bytes.inc(n)
            return {"ok": True}, [bytes(v[off:off + n])]
        finally:
            del v
            self.store.release(oid)

    def _h_pull_object(self, msg, frames):
        """Whole-object pull (small objects / direct driver fallback)."""
        oid = msg["oid"]
        v = self.store.get(oid)
        if v is None:
            return {"ok": False, "error": "absent"}
        try:
            self._m_push_bytes.inc(v.nbytes)
            return {"ok": True}, [bytes(v)]
        finally:
            del v
            self.store.release(oid)

    def _h_free_object(self, msg, frames):
        """Owner dropped its last reference: drop the creator/primary pin
        (held since create+seal so eviction can't reclaim live objects —
        reference: raylet pins primary copies) and reclaim the space if no
        reader still holds a zero-copy view; otherwise the entry falls to
        the LRU list when the last reader releases."""
        try:
            self.store.release(msg["oid"])
            self.store.delete(msg["oid"])
        except Exception:
            pass

    # ------------------------------------------------------------ bundles

    def _h_reserve_bundle(self, msg, frames):
        req = msg["resources"]
        key = (msg["pg_id"], msg["bundle_index"])
        with self._lock:
            if key in self._bundles:
                return {"ok": True}
            if not self._can_run(req):
                return {"ok": False}
            for r, q in req.items():
                self._available[r] = _fpq(self._available[r] - q)
            self._bundles[key] = dict(req)
            self._bundle_free[key] = dict(req)
        return {"ok": True}

    def _h_release_bundle(self, msg, frames):
        key = (msg["pg_id"], msg["bundle_index"])
        with self._lock:
            req = self._bundles.pop(key, None)
            self._bundle_free.pop(key, None)
            if req:
                for r, q in req.items():
                    self._available[r] = min(self.resources.get(r, 0.0),
                                             _fpq(self._available[r] + q))
        return {"ok": True}

    def _h_node_info(self, msg, frames):
        with self._lock:
            return {"node_id": self.node_id, "address": self.address,
                    "store_name": self.store.name, "resources": self.resources,
                    "available": dict(self._available), "labels": self.labels,
                    "num_workers": len(self._workers),
                    "oom_kills": self._oom_kills}

    def _h_node_metrics(self, msg, frames):
        """This node's metrics page: the nodelet's PRIVATE registry
        (store/transfer metrics — never aliased with other in-process
        nodelets) plus every ready worker's page (scraped over the
        metrics_text RPC), each worker tagged with its proc id so
        same-named series from different processes stay distinct. The
        head merges these pages cluster-wide with a node tag
        (reference: per-node metrics agents feeding the dashboard's
        Prometheus surface). Worker processes are real OS processes
        even in in-process test clusters, so their attribution is
        always exact."""
        from ray_tpu_torch.util import metrics as _metrics

        try:
            st = self.store.stats()
            self._m_store_allocated.set(st.get("bytes_allocated", 0))
            self._m_store_objects.set(st.get("num_objects", 0))
            self._m_store_evictions.set(st.get("evictions", 0))
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            targets = [(w.worker_id.hex()[:12], w.address)
                       for w in self._workers.values()
                       if w.address and w.ready.is_set()]
        pages = [({"proc": "nodelet"},
                  _metrics.prometheus_text(self._metrics_registry))]
        pages += _metrics.scrape_pages(self.client, targets,
                                       "metrics_text", 5.0, "proc")
        return {"text": _metrics.merge_prometheus(pages)}

    def _h_profile_capture(self, msg, frames):
        """One node's slice of a cluster profile: fan the capture out to
        every ready worker via call_gather (ONE shared deadline — a hung
        worker costs the fan-out its timeout, not timeout-per-worker)
        while a sampler covers this nodelet's own process for the same
        window; merge proc-tagged collapsed pages. The head stamps the
        node tag when it merges node pages."""
        from ray_tpu_torch.util import profiler

        duration = max(0.05, min(float(msg.get("duration_s", 5.0)),
                                 profiler.MAX_CAPTURE_S))
        hz = msg.get("hz")
        with self._lock:
            targets = [(w.worker_id.hex()[:12], w.address)
                       for w in self._workers.values()
                       if w.address and w.ready.is_set()]
        own = profiler.StackSampler(hz=hz).start()
        # timer-bounded self-sample: a hung worker parks call_gather
        # for its full timeout, which must not weigh this nodelet's
        # page heavier than its workers' in the merged counts
        stopper = threading.Timer(duration, own.stop)
        stopper.daemon = True
        stopper.start()
        t0 = time.monotonic()
        try:
            results = self.client.call_gather(
                [(a, "profile_capture", {"duration_s": duration, "hz": hz})
                 for _, a in targets],
                timeout=duration + 10.0)
            # hold the local window open for its full length even when
            # the worker fan-out returns early (e.g. zero workers);
            # stop-aware so shutdown ends the window early
            rem = duration - (time.monotonic() - t0)
            if rem > 0:
                self._stopped.wait(rem)
        finally:
            stopper.cancel()
            own.stop()
        profiler._note_capture(own)
        pages = [profiler.prefix_stacks(own.collapsed(), "proc:nodelet")]
        samples, dropped, procs = own.samples, own.stacks_dropped, 1
        for (wid, _), r in zip(targets, results):
            if r is None:
                continue  # dead/slow worker: the rest of the page stands
            pages.append(profiler.prefix_stacks(r["stacks"], f"proc:{wid}"))
            samples += r["samples"]
            dropped += r["dropped"]
            procs += 1
        return {"stacks": profiler.merge_collapsed(pages),
                "samples": samples, "dropped": dropped, "procs": procs,
                "hz": own.hz}

    def _h_node_cpu_stats(self, msg, frames):
        """Aggregate every ready worker's per-task CPU attribution
        table (one call_gather pass, proc-tagged rows)."""
        with self._lock:
            targets = [(w.worker_id.hex()[:12], w.address)
                       for w in self._workers.values()
                       if w.address and w.ready.is_set()]
        results = self.client.call_gather(
            [(a, "cpu_stats", {}) for _, a in targets], timeout=5.0)
        rows = []
        for (wid, _), r in zip(targets, results):
            if r is None:
                continue
            for row in r.get("rows", ()):
                rows.append({**row, "proc": wid})
        return {"rows": rows, "node_id": self.node_id}

    def _h_list_node_objects(self, msg, frames):
        """Aggregate this node's owner-side object tables + store stats
        (reference: the raylet answers `ray memory` for its workers by
        fanning out to their core workers)."""
        with self._lock:
            addrs = [w.address for w in self._workers.values()
                     if w.address and w.ready.is_set()]
        objects = []
        for a in addrs:
            try:
                r = self.client.call(a, "list_objects", {}, timeout=5)
                objects.extend(r.get("objects", ()))
            except Exception:  # noqa: BLE001
                pass  # worker mid-exit
        try:
            store = self.store.stats()
        except Exception:  # noqa: BLE001
            store = {}
        return {"objects": objects, "store": store,
                "node_id": self.node_id, "address": self.address,
                "oom_kills": self._oom_kills}


def _worker_died_error(name: str, code):
    from ray_tpu_torch.core import exceptions as exc

    return exc.WorkerCrashedError(
        f"worker executing {name!r} died unexpectedly (exit code {code})")


def _oom_killed_error(name: str):
    from ray_tpu_torch.core import exceptions as exc

    return exc.OutOfMemoryError(
        f"worker executing {name!r} was killed by the node memory monitor "
        f"to relieve memory pressure (reference: OOM killer semantics)")


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--head-address", required=True)
    ap.add_argument("--resources", required=True)  # json
    ap.add_argument("--labels", default="{}")
    ap.add_argument("--session-dir", default=None)
    ap.add_argument("--address-file", default=None)
    ap.add_argument("--store-capacity", type=int, default=None)
    args = ap.parse_args()
    import json

    nl = Nodelet(args.head_address, json.loads(args.resources),
                 labels=json.loads(args.labels), session_dir=args.session_dir,
                 store_capacity=args.store_capacity).start()
    # structured logging for the nodelet's own process (workers install
    # their own in worker_main; in-process test nodelets deliberately
    # leave the host process's logging untouched)
    from ray_tpu_torch.utils import logging as slog

    slog.install_process_logging(role="nodelet", log_dir=nl.log_dir,
                                 node_id=nl.node_id.hex()[:12],
                                 proc="nodelet")
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(nl.address)
        os.replace(tmp, args.address_file)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    nl.stop()


if __name__ == "__main__":
    main()
