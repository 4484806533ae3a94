"""Head service — the cluster control plane.

Reference parity: the GCS server (src/ray/gcs/gcs_server/gcs_server.h:89)
composed of node manager, actor manager/scheduler, KV, pubsub and health
checks. Matching the reference's key design fact: the head is NOT on the
task hot path — tasks flow driver→nodelet→worker and results flow
worker→owner directly; the head only sees node membership, actor
lifecycle, the function/KV store, and placement groups.

Runs either embedded in the driver process tree (ray_tpu_torch.init()
local boot) or standalone via `python -m ray_tpu_torch.core.head`.

The port's copy of ``ray_tpu/core/head.py``, with its observability
planes: the Watchtower starts and stops with the head, and the head
answers the metrics plane (cluster_metrics, metrics_history, alerts,
the /metrics HTTP page), the structured log plane (cluster_logs), the
profiler (profile_capture), the timeline and the task ledger.
"""

from __future__ import annotations

import threading
import time

from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.rpc import RpcClient, RpcServer
from ray_tpu_torch.core.specs import ActorSpec, NodeInfo
from ray_tpu_torch.core.task_ledger import TERMINAL_STATES

HEARTBEAT_INTERVAL_S = 0.5
NODE_DEATH_AFTER_S = 5.0


class ActorState:
    PENDING = "PENDING"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class _ActorRecord:
    __slots__ = ("spec", "state", "address", "node_id", "restarts_left",
                 "death_cause", "cond")

    def __init__(self, spec: ActorSpec):
        self.spec = spec
        self.state = ActorState.PENDING
        self.address = None
        self.node_id = None
        self.restarts_left = spec.max_restarts
        self.death_cause = ""
        self.cond = threading.Condition()


class Head:
    def __init__(self, session_name: str = "session", storage=None,
                 span_capacity: int = 50_000,
                 span_spill_dir: str | None = None,
                 span_spill_max_bytes: int = 64 << 20,
                 span_rate_limit: float | None = None,
                 watchtower_period_s: float | None = None,
                 watchtower_rules: list | None = None,
                 watchtower_autodump: str | bool | None = None,
                 watchtower_autodump_cooldown_s: float | None = None):
        from ray_tpu_torch.core.head_storage import InMemoryHeadStore

        self.server = RpcServer(name="head", num_threads=32)
        self.address = self.server.address
        self.client = RpcClient.shared()
        self.session_name = session_name
        # pluggable metadata store (reference: gcs store_client seam) —
        # FileHeadStore makes KV/actors/jobs survive a head restart
        self.storage = storage or InMemoryHeadStore()

        self._lock = threading.RLock()
        self._nodes: dict[bytes, NodeInfo] = {}
        self._available: dict[bytes, dict] = {}
        self._last_beat: dict[bytes, float] = {}
        self._kv: dict[str, dict[bytes, bytes]] = {}
        self._actors: dict[bytes, _ActorRecord] = {}
        self._named: dict[tuple[str, str], bytes] = {}
        self._subs: dict[str, set[str]] = {}  # topic -> subscriber addresses
        self._pgs = {}  # placement groups: pg_id -> record (see placement.py)
        from collections import deque as _dq

        self._task_events = _dq(maxlen=10000)
        # raw span buffer for the merged cluster timeline: workers and
        # drivers flush their TaskEventLogs here over the task_events
        # oneway channel (reference: TaskEventBuffer -> GcsTaskManager).
        # Overflow beyond span_capacity SPILLS to bounded on-disk JSONL
        # (oldest first) instead of vanishing; dump_timeline merges the
        # spill back in, so the timeline window is disk-bounded, not
        # 50k-spans-bounded.
        self._span_events = _dq()
        self._span_capacity = span_capacity
        from ray_tpu_torch.utils.events import SpanSpill

        self._span_spill = SpanSpill(span_spill_dir, span_spill_max_bytes)
        # task lifecycle ledger (reference: GcsTaskManager's bounded
        # task-event store behind `ray list tasks` / `ray summary`):
        # joins the same oneway inflow per task_id into an explicit
        # state machine with transition history; the flat _task_events
        # window above stays as the legacy list_tasks view
        from ray_tpu_torch.core.task_ledger import TaskLedger

        self._ledger = TaskLedger()
        # span-policy plane (head-driven sampling for >10k spans/s):
        # operator policy wins; otherwise an automatic per-producer rate
        # limit kicks in when cluster-wide inflow exceeds the cap
        import os as _os

        self._span_rate_limit = float(
            span_rate_limit if span_rate_limit is not None
            else _os.environ.get("RAY_TPU_SPAN_RATE_LIMIT", 10_000.0))
        self._span_policy: dict | None = None  # guarded_by(_lock)
        self._span_inflow = _dq()  # (monotonic, n) — guarded_by(_lock)
        self._span_producers: dict[str, float] = {}  # guarded_by(_lock)
        # hysteresis for automatic mode: once engaged, the limit stays
        # until inflow drops well below the cap — the head observes
        # POST-sampling inflow, so releasing at the cap would oscillate
        # (throttle -> inflow falls -> release -> flood -> repeat)
        self._span_auto_engaged = False  # guarded_by(_lock)
        # long-poll subscriber mailboxes: sub_id -> {topics, queue, cond}
        self._poll_subs: dict = {}
        self._queue_lens: dict[bytes, int] = {}  # pending tasks per node
        self._queued_demands: dict[bytes, dict] = {}  # queued shapes/node
        self._stopped = threading.Event()
        # storage writes are queued IN LOCK ORDER and drained by one
        # writer thread: disk order then matches memory order without
        # doing blocking I/O under the head lock
        self._persist_queue: list[tuple] = []
        self._persist_wake = threading.Event()
        self._restore_from_storage()

        s = self.server
        s.register("register_node", self._h_register_node)
        s.register("heartbeat", self._h_heartbeat, oneway=True)
        s.register("cluster_view", self._h_cluster_view)
        s.register("kv_put", self._h_kv_put)
        s.register("kv_get", self._h_kv_get)
        s.register("kv_del", self._h_kv_del)
        s.register("kv_keys", self._h_kv_keys)
        s.register("create_actor", self._h_create_actor)
        s.register("actor_ready", self._h_actor_ready, oneway=True)
        s.register("actor_died", self._h_actor_died)
        s.register("get_actor", self._h_get_actor)
        s.register("get_named_actor", self._h_get_named_actor)
        # slow lane (like create_pg below): parks up to 10s on a sync
        # stop_actor call into the nodelet, and a fast-lane handler
        # that waits on a service whose handlers call back into the
        # head is the GL013 reentry-cycle shape
        s.register("kill_actor", self._h_kill_actor, slow=True)
        s.register("subscribe", self._h_subscribe)
        s.register("poll_messages", self._h_poll_messages, slow=True)
        s.register("unsubscribe", self._h_unsubscribe)
        s.register("publish", self._h_publish, oneway=True)
        # slow lane: the 2PC reservation loop makes one 10s-timeout RPC
        # per bundle to the nodelets — parking that long on the
        # control-plane pool risks starving it, and a nodelet handler
        # synchronously calling back into the head (GL013 chain:
        # create_pg -> reserve_bundle -> nodelet._h_schedule_task ->
        # head cluster_view) could then deadlock the two pools against
        # each other
        s.register("create_pg", self._h_create_pg, slow=True)
        s.register("pg_table", self._h_pg_table)
        # slow lane: one 10s-timeout release_bundle call per bundle
        # (same reasoning as create_pg/kill_actor)
        s.register("remove_pg", self._h_remove_pg, slow=True)
        s.register("list_actors", self._h_list_actors)
        s.register("task_event", self._h_task_event, oneway=True)
        s.register("task_events", self._h_task_events, oneway=True)
        s.register("span_policy", self._h_span_policy)
        s.register("list_tasks", self._h_list_tasks)
        s.register("task_ledger", self._h_task_ledger)
        # slow lane: explain fans out to every alive nodelet under one
        # shared deadline (the cluster_logs shape) for live queue state
        s.register("explain_task", self._h_explain_task, slow=True)
        # big payload / fan-out surfaces ride the slow lane so a timeline
        # dump or metrics scrape never starves heartbeats
        s.register("dump_timeline", self._h_dump_timeline, slow=True)
        s.register("cluster_metrics", self._h_cluster_metrics, slow=True)
        s.register("metrics_history", self._h_metrics_history, slow=True)
        # cluster-wide sampling profile: blocks for the capture window
        # while fanning out to every alive nodelet (never back into this
        # server's own pool — the GL013 shape)
        s.register("profile_capture", self._h_profile_capture, slow=True)
        # structured-log fan-out: one call_gather sweep over alive
        # nodelets' log_query under ONE shared deadline (a dead node =
        # an `errors` entry, the profile-capture shape)
        s.register("cluster_logs", self._h_cluster_logs, slow=True)
        s.register("alerts", self._h_alerts)
        s.register("ping", lambda m, f: "pong")
        # watchtower: the always-on consumer of the scrape fan-out —
        # metric history, SLO rules, alerts, alert-triggered dumps. Its
        # sampling loop is the head's own thread (period_s apart), so
        # history/alerting never touches a request hot path.
        from ray_tpu_torch.util.watchtower import Watchtower

        self.watchtower = Watchtower(
            scrape=self._cluster_metrics_text,
            period_s=watchtower_period_s,
            rules=watchtower_rules,
            autodump=watchtower_autodump,
            autodump_cooldown_s=watchtower_autodump_cooldown_s,
            address_fn=lambda: self.address,
            span_sink=self._ingest_spans,
            log_context_fn=self._watchtower_log_context)
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True,
                                         name="head-monitor")
        self._pg_retry = threading.Thread(target=self._pg_retry_loop,
                                          daemon=True, name="head-pg-retry")
        self._persister = threading.Thread(target=self._persist_loop,
                                           daemon=True, name="head-persist")

    def _restore_from_storage(self):
        """Reload persisted tables (reference: gcs_init_data.h — the GCS
        reloads state on boot; live nodes re-register via heartbeats).
        Actors that were ALIVE when the head died are marked DEAD: their
        workers registered with the previous incarnation."""
        from ray_tpu_torch.core import head_storage as hs

        for key, blob in self.storage.scan("kv"):
            ns, _, k = key.partition("\x00")
            self._kv.setdefault(ns, {})[k] = blob
        for aid, blob in self.storage.scan("actors"):
            try:
                rec_data = hs.loads(blob)
            except Exception:  # noqa: BLE001
                continue
            rec = _ActorRecord(rec_data["spec"])
            rec.state = ActorState.DEAD
            rec.death_cause = (rec_data.get("death_cause") or
                               "head restarted")
            self._actors[aid] = rec
            if rec.spec.name:
                self._named.setdefault(
                    (rec.spec.namespace, rec.spec.name), aid)

    def _persist_actor(self, rec: "_ActorRecord"):
        from ray_tpu_torch.core import head_storage as hs

        try:
            self.storage.put("actors", rec.spec.actor_id, hs.dumps({
                "spec": rec.spec, "state": rec.state,
                "death_cause": rec.death_cause}))
        except Exception:  # noqa: BLE001
            pass

    def start(self):
        self.server.start()
        self._monitor.start()
        self._pg_retry.start()
        self._persister.start()
        self.watchtower.start()
        return self

    def _enqueue_persist(self, op: str, table: str, key, value=None):
        # caller holds self._lock: queue order == memory mutation order
        self._persist_queue.append((op, table, key, value))
        self._persist_wake.set()

    def _persist_loop(self):
        while not self._stopped.is_set():
            self._persist_wake.wait(timeout=0.2)
            self._persist_wake.clear()
            while True:
                with self._lock:
                    if not self._persist_queue:
                        break
                    op, table, key, value = self._persist_queue.pop(0)
                try:
                    if op == "put":
                        self.storage.put(table, key, value)
                    else:
                        self.storage.delete(table, key)
                except Exception:  # noqa: BLE001
                    pass

    def stop(self):
        # flush queued persists before stopping
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with self._lock:
                if not self._persist_queue:
                    break
            time.sleep(0.02)
        self._stopped.set()
        self.watchtower.stop()
        self.server.stop()

    # ------------------------------------------------------------ nodes

    def _h_register_node(self, msg, frames):
        info = NodeInfo(**msg["node"])
        with self._lock:
            self._nodes[info.node_id] = info
            self._available[info.node_id] = dict(info.resources)
            self._last_beat[info.node_id] = time.monotonic()
        self._publish("node", {"event": "added", "node_id": info.node_id.hex()})
        return {"num_nodes": len(self._nodes)}

    def _h_heartbeat(self, msg, frames):
        nid = msg["node_id"]
        with self._lock:
            if nid in self._nodes:
                self._last_beat[nid] = time.monotonic()
                # delta sync: a payload-less beat is liveness-only (the
                # nodelet's resources are unchanged — ray_syncer.h:83)
                if "available" in msg:
                    self._available[nid] = msg["available"]
                    self._queue_lens[nid] = msg.get("queue_len", 0)
                    self._queued_demands[nid] = msg.get("queued_demand", {})
                self._nodes[nid].alive = True

    def _h_cluster_view(self, msg, frames):
        with self._lock:
            return {
                "nodes": [
                    {
                        "node_id": n.node_id,
                        "address": n.address,
                        "resources": n.resources,
                        "available": self._available.get(n.node_id, {}),
                        "labels": n.labels,
                        "store_name": n.store_name,
                        "alive": n.alive,
                        "queue_len": self._queue_lens.get(n.node_id, 0),
                        "queued_demand": self._queued_demands.get(
                            n.node_id, {}),
                    }
                    for n in self._nodes.values()
                ]
            }

    def _monitor_loop(self):
        """Health checks (reference: gcs_health_check_manager.h:45 — the
        GCS probes nodes; here nodes push heartbeats and we age them)."""
        while not self._stopped.wait(HEARTBEAT_INTERVAL_S):
            now = time.monotonic()
            dead = []
            with self._lock:
                for nid, info in self._nodes.items():
                    if info.alive and now - self._last_beat.get(nid, 0) > NODE_DEATH_AFTER_S:
                        info.alive = False
                        dead.append(nid)
                # timer-driven GC of abandoned long-poll mailboxes (must
                # not depend on publishes happening: quiet clusters would
                # otherwise leak dead subscribers' buffers forever)
                stale = now - 120.0
                for sub_id, box in list(self._poll_subs.items()):
                    if box["last_seen"] < stale:
                        self._poll_subs.pop(sub_id, None)
                        box["cond"].notify_all()
            for nid in dead:
                self._on_node_death(nid)

    def _on_node_death(self, node_id: bytes):
        self._publish("node", {"event": "removed", "node_id": node_id.hex()})
        # Actors on the dead node die (and maybe restart elsewhere):
        with self._lock:
            affected = [r for r in self._actors.values()
                        if r.node_id == node_id and r.state == ActorState.ALIVE]
        for rec in affected:
            self._actor_died(rec, f"node {node_id.hex()[:12]} died")

    # ------------------------------------------------------------ kv

    def _h_kv_put(self, msg, frames):
        ns = msg.get("ns", "default")
        with self._lock:
            table = self._kv.setdefault(ns, {})
            exists = msg["key"] in table
            if msg.get("overwrite", True) or not exists:
                value = frames[0] if frames else msg.get("value", b"")
                table[msg["key"]] = value
                self._enqueue_persist("put", "kv", f"{ns}\x00{msg['key']}",
                                      value)
        return {"added": not exists}

    def _h_kv_get(self, msg, frames):
        with self._lock:
            v = self._kv.get(msg.get("ns", "default"), {}).get(msg["key"])
        return ({"found": v is not None}, [v] if v is not None else [])

    def _h_kv_del(self, msg, frames):
        ns = msg.get("ns", "default")
        with self._lock:
            removed = self._kv.get(ns, {}).pop(msg["key"], None) is not None
            if removed:
                self._enqueue_persist("del", "kv", f"{ns}\x00{msg['key']}")
            return {"deleted": removed}

    def _h_kv_keys(self, msg, frames):
        prefix = msg.get("prefix", b"")
        with self._lock:
            return {"keys": [k for k in self._kv.get(msg.get("ns", "default"), {})
                             if k.startswith(prefix)]}

    # ------------------------------------------------------------ actors

    def _h_create_actor(self, msg, frames):
        spec = ActorSpec(**msg["spec"])
        spec.cls_blob = frames[0] if frames else spec.cls_blob
        with self._lock:
            if spec.name:
                key = (spec.namespace, spec.name)
                existing = self._named.get(key)
                if existing is not None:
                    rec = self._actors.get(existing)
                    if rec is not None and rec.state != ActorState.DEAD:
                        if msg.get("get_if_exists"):
                            return {"actor_id": existing, "existing": True}
                        raise ValueError(f"actor name {spec.name!r} already taken")
                self._named[key] = spec.actor_id
            self._actors[spec.actor_id] = _ActorRecord(spec)
        self._persist_actor(self._actors[spec.actor_id])
        self._schedule_actor(self._actors[spec.actor_id])
        return {"actor_id": spec.actor_id, "existing": False}

    def _pick_node(self, resources: dict, pg: bytes | None = None,
                   bundle_index: int = -1, label_selector: dict | None = None,
                   exclude: set | None = None, require_avail: bool = False):
        """Best-fit placement over the freshest resource view (reference:
        GcsActorScheduler / hybrid policy; simplified to best-fit since
        nodelets do their own local queueing). Picking a node decrements
        the head's view of its availability immediately so concurrent
        placements in one heartbeat window don't double-place (the next
        heartbeat overwrites the view with ground truth)."""
        from ray_tpu_torch.core.placement import pg_bundle_node
        with self._lock:
            if pg is not None:
                nid = pg_bundle_node(self._pgs, pg, bundle_index, resources)
                if nid is not None and nid in self._nodes and self._nodes[nid].alive:
                    return self._nodes[nid]
                return None
            from ray_tpu_torch.util.scheduling_strategies import (
                split_soft_selector,
            )

            sel, soft_sel = split_soft_selector(label_selector)

            def scan(selector):
                best, best_score = None, None
                for n in self._nodes.values():
                    if not n.alive or (exclude and n.node_id in exclude):
                        continue
                    if selector and any(n.labels.get(k) != v
                                        for k, v in selector.items()):
                        continue
                    avail = self._available.get(n.node_id, {})
                    total = n.resources
                    if any(total.get(r, 0.0) < q
                           for r, q in resources.items()):
                        continue  # infeasible on this node
                    if require_avail and any(avail.get(r, 0.0) < q
                                             for r, q in resources.items()):
                        continue
                    free = sum(min(avail.get(r, 0.0) / q, 10.0)
                               for r, q in resources.items() if q) \
                        if resources else sum(avail.values())
                    if best_score is None or free > best_score:
                        best, best_score = n, free
                return best

            best = scan(sel)
            if best is None and soft_sel and sel:
                # soft affinity: the preferred node is gone — fall back
                # to any feasible node (reference:
                # scheduling_strategies.py soft semantics)
                best = scan({})
            if best is not None:
                avail = self._available.get(best.node_id)
                if avail is not None:
                    for r, q in resources.items():
                        avail[r] = avail.get(r, 0.0) - q
            return best

    def _schedule_actor(self, rec: _ActorRecord):
        """Place and start an actor, retrying other nodes on start
        failure. A scheduling race (stale resource view, nodelet refusing
        with 'insufficient resources') must NOT consume the actor's
        restart budget — only post-ALIVE deaths do (reference:
        GcsActorScheduler reschedules on lease rejection)."""

        def run():
            deadline = time.monotonic() + 60
            failed: set = set()
            while time.monotonic() < deadline and not self._stopped.is_set():
                with rec.cond:
                    if rec.state == ActorState.DEAD:
                        return
                node = self._pick_node(rec.spec.resources,
                                       rec.spec.placement_group,
                                       rec.spec.bundle_index,
                                       rec.spec.label_selector,
                                       exclude=failed, require_avail=True)
                if node is None and failed:
                    # every available node refused: widen to any feasible
                    node = self._pick_node(rec.spec.resources,
                                           rec.spec.placement_group,
                                           rec.spec.bundle_index,
                                           rec.spec.label_selector,
                                           require_avail=True)
                if node is not None:
                    with self._lock:
                        rec.node_id = node.node_id
                    try:
                        self.client.call(node.address, "start_actor",
                                         {"spec": dataclass_dict(rec.spec)},
                                         frames=[rec.spec.cls_blob], timeout=60)
                        return  # started; actor_ready/actor_died drive the rest
                    except Exception:  # noqa: BLE001
                        failed.add(node.node_id)
                time.sleep(0.2)
            self._actor_died(rec, "no feasible node for actor resources "
                             f"{rec.spec.resources}", allow_restart=False)

        threading.Thread(target=run, daemon=True, name="actor-schedule").start()

    def _h_actor_ready(self, msg, frames):
        with self._lock:
            rec = self._actors.get(msg["actor_id"])
        if rec is None:
            return
        with rec.cond:
            rec.state = ActorState.ALIVE
            rec.address = msg["address"]
            rec.cond.notify_all()
        self._publish("actor", {"event": "ready", "actor_id": msg["actor_id"].hex(),
                                "address": msg["address"]})

    def _h_actor_died(self, msg, frames):
        with self._lock:
            rec = self._actors.get(msg["actor_id"])
        if rec is not None:
            self._actor_died(rec, msg.get("cause", "worker died"),
                             allow_restart=not msg.get("no_restart", False))
        return {}

    def _actor_died(self, rec: _ActorRecord, cause: str, allow_restart: bool = True):
        with rec.cond:
            if rec.state == ActorState.DEAD:
                return
            restart = allow_restart and rec.restarts_left != 0
            if restart:
                if rec.restarts_left > 0:
                    rec.restarts_left -= 1
                rec.state = ActorState.RESTARTING
                rec.address = None
            else:
                rec.state = ActorState.DEAD
                rec.death_cause = cause
            rec.cond.notify_all()
        self._publish("actor", {"event": "restarting" if restart else "dead",
                                "actor_id": rec.spec.actor_id.hex(), "cause": cause})
        self._persist_actor(rec)
        if restart:
            self._schedule_actor(rec)

    def _h_get_actor(self, msg, frames):
        aid = msg["actor_id"]
        timeout = msg.get("timeout", 60.0)
        with self._lock:
            rec = self._actors.get(aid)
        if rec is None:
            return {"state": "UNKNOWN"}
        deadline = time.monotonic() + timeout
        with rec.cond:
            while rec.state in (ActorState.PENDING, ActorState.RESTARTING):
                if not msg.get("wait", True):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                rec.cond.wait(remaining)
            return {"state": rec.state, "address": rec.address,
                    "cause": rec.death_cause}

    def _h_get_named_actor(self, msg, frames):
        key = (msg.get("namespace", "default"), msg["name"])
        with self._lock:
            aid = self._named.get(key)
            rec = self._actors.get(aid) if aid else None
            if rec is None or rec.state == ActorState.DEAD:
                return {"found": False}
        return {"found": True, "actor_id": aid}

    def _h_kill_actor(self, msg, frames):
        with self._lock:
            rec = self._actors.get(msg["actor_id"])
        if rec is None:
            return {}
        no_restart = msg.get("no_restart", True)
        node = self._nodes.get(rec.node_id) if rec.node_id else None
        if node is not None:
            try:
                self.client.call(node.address, "stop_actor",
                                 {"actor_id": msg["actor_id"]}, timeout=10)
            except Exception:
                pass
        self._actor_died(rec, "killed via ray_tpu_torch.kill()",
                         allow_restart=not no_restart)
        return {}

    def _h_task_event(self, msg, frames):
        """Executor-side task lifecycle events (reference:
        TaskEventBuffer -> GcsTaskManager, gcs_task_manager.h:86 —
        bounded in-memory store feeding the state API). The flat
        `list_tasks` window keeps its one-terminal-row-per-attempt
        shape; intermediate lifecycle states live in the ledger."""
        if msg.get("state") in TERMINAL_STATES:
            with self._lock:
                self._task_events.append(msg)
        self._ledger.ingest((msg,))

    def _ingest_spans(self, spans) -> None:
        """Append flushed spans to the bounded in-memory window, spilling
        the overflow (oldest first) to disk. The spill write happens
        OUTSIDE the head lock — disk latency must never stall heartbeat
        or ingest handlers."""
        if not spans:
            return
        now = time.monotonic()
        overflow: list = []
        with self._lock:
            self._span_events.extend(spans)
            while len(self._span_events) > self._span_capacity:
                overflow.append(self._span_events.popleft())
            # inflow accounting for the auto rate-limit policy
            self._span_inflow.append((now, len(spans)))
            while self._span_inflow and self._span_inflow[0][0] < now - 10:
                self._span_inflow.popleft()
            for s in spans:
                proc = s.get("proc")
                if proc:
                    self._span_producers[proc] = now
                    break  # one batch = one producer
            if len(self._span_producers) > 512:
                self._span_producers = {
                    p: t for p, t in self._span_producers.items()
                    if t > now - 60}
        if overflow:
            self._span_spill.append(overflow)

    def _h_task_events(self, msg, frames):
        """Batched variant (workers buffer events; reference:
        task_event_buffer.h periodic flush). Also the span-flush channel:
        the same oneway carries raw TaskEventLog spans for the merged
        cluster timeline."""
        events = msg.get("events", ())
        flat = [e for e in events if e.get("state") in TERMINAL_STATES]
        if flat:
            with self._lock:
                self._task_events.extend(flat)
        self._ledger.ingest(events)
        self._ingest_spans(msg.get("spans", ()))

    def set_span_policy(self, policy: dict | None) -> None:
        """Operator-set span sampling policy, served to every producer
        via the `span_policy` RPC (``{"max_per_s": N, "categories":
        {cat: N}}``, 0/absent = unlimited). None reverts to automatic
        mode: unlimited until cluster inflow crosses the head's rate
        cap, then a per-producer share of the cap."""
        with self._lock:
            self._span_policy = dict(policy) if policy else None

    def _h_span_policy(self, msg, frames):
        now = time.monotonic()
        with self._lock:
            if self._span_policy is not None:
                return {"policy": self._span_policy}
            inflow = sum(n for t, n in self._span_inflow
                         if t > now - 10) / 10.0
            producers = sum(1 for t in self._span_producers.values()
                            if t > now - 30)
            if inflow > self._span_rate_limit:
                self._span_auto_engaged = True
            elif inflow < self._span_rate_limit / 4:
                # release only when POST-sampling inflow sits far below
                # the cap: at the cap itself the throttle is what is
                # holding inflow down, and releasing would flood again
                self._span_auto_engaged = False
            if not self._span_auto_engaged:
                return {"policy": None}
            per_producer = self._span_rate_limit / max(1, producers)
            return {"policy": {"max_per_s": per_producer}}

    def _h_list_tasks(self, msg, frames):
        limit = int(msg.get("limit", 1000))
        with self._lock:
            events = list(self._task_events)[-limit:]
        return {"tasks": events}

    def _h_task_ledger(self, msg, frames):
        """Ledger query: per-state counts + ring stats, one record by
        task_id prefix, or the last-N record summaries."""
        out = {"counts": self._ledger.counts(),
               "stats": self._ledger.stats()}
        tid = msg.get("task_id")
        if tid:
            out["record"] = self._ledger.get(str(tid))
        limit = int(msg.get("limit", 0))
        if limit > 0:
            out["records"] = self._ledger.recent(limit)
        return out

    def _h_explain_task(self, msg, frames):
        """`ray_tpu explain <task_id>`: the ledger's view of one task
        plus, for a task that is not yet terminal, each alive nodelet's
        live placement explanation (is it queued there, how long, what
        the last verdict rejected). Fan-out runs under ONE shared
        deadline; a dead node becomes an `errors` entry, never a
        failed gather (the profile-capture/cluster_logs shape)."""
        from ray_tpu_torch.core import task_ledger as tl

        tid = str(msg.get("task_id") or "").lower()
        timeout = min(float(msg.get("timeout", 10.0)), 60.0)
        rec = self._ledger.get(tid)
        out: dict = {"task_id": tid, "record": rec, "errors": {}}
        if rec is not None:
            out["waterfall"] = tl.waterfall(rec)
            if rec.get("verdict") is not None:
                out["verdict"] = rec["verdict"]
        if rec is not None and rec.get("state") in tl.TERMINAL_STATES:
            return out
        with self._lock:
            targets = [(n.node_id.hex()[:12], n.address)
                       for n in self._nodes.values() if n.alive]
        results = self.client.call_gather(
            [(addr, "explain_task", {"task_id": tid})
             for _, addr in targets], timeout=timeout)
        nodes = {}
        for (nid, _), r in zip(targets, results):
            if r is None:
                out["errors"][nid] = "explain_task failed or timed out"
            else:
                nodes[nid] = r
        out["nodes"] = nodes
        # a task parked DRIVER-side waiting for a lease grant is in no
        # nodelet queue, so no fan-out target can explain it — but its
        # QUEUED verdict carries the resource request, and the head owns
        # the authoritative node table: compute the feasibility verdict
        # here (same reason strings as the nodelet's _consider_nodes)
        if (rec is not None
                and not any(r.get("queued") for r in nodes.values())):
            req = (rec.get("verdict") or {}).get("resources")
            if req:
                considered, constraint = self._consider_nodes(req)
                v = dict(rec.get("verdict") or {})
                v["nodes_considered"] = considered
                if constraint:
                    v["constraint"] = constraint
                out["verdict"] = v
        return out

    def _consider_nodes(self, req: dict) -> tuple[list, str | None]:
        """Per-node feasibility for a resource request against the
        head's own node table — (entries, constraint), where constraint
        names the unsatisfiable requirement when NO alive node has the
        total capacity, None when the request is merely busy-waiting."""
        with self._lock:
            view = [(n.node_id, n.alive, dict(n.resources),
                     dict(self._available.get(n.node_id, {})))
                    for n in self._nodes.values()]
        entries = []
        any_total_fit = False
        for nid, alive, total, avail in view:
            e = {"node_id": nid.hex()[:12], "ok": False}
            if not alive:
                e["reason"] = "dead"
                entries.append(e)
                continue
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
        if not any_total_fit:
            constraint = (f"no node in the cluster has total capacity "
                          f"for resources {req}")
        return entries, constraint

    def _h_dump_timeline(self, msg, frames):
        """Raw cluster-wide span buffer (reference: `ray timeline` over
        the GCS task events). The caller's own just-drained spans ride
        in the request and are appended first, so a one-shot dump always
        includes them (no oneway/call ordering to rely on). Non-draining
        otherwise: repeated dumps see history up to the in-memory cap
        PLUS whatever the bounded on-disk spill still holds — spilled
        spans merge back transparently."""
        limit = int(msg.get("limit", 200_000))
        self._ingest_spans(msg.get("spans", ()))
        spilled = self._span_spill.read()
        with self._lock:
            spans = spilled + list(self._span_events)
        return {"spans": spans[-limit:]}

    # ------------------------------------------------------------ metrics

    def _cluster_metrics_text(self) -> str:
        """One Prometheus page for the whole cluster: scrape every alive
        nodelet's node_metrics (which itself fans out to its workers)
        and inject the node id as a label (reference: the dashboard's
        cluster-level metrics aggregation over per-node agents)."""
        from ray_tpu_torch.util import metrics as _metrics

        with self._lock:
            targets = [(n.node_id.hex()[:12], n.address)
                       for n in self._nodes.values() if n.alive]
        pages = [({"node": "head"}, _metrics.prometheus_text())]
        pages += _metrics.scrape_pages(self.client, targets,
                                       "node_metrics", 10.0, "node")
        return _metrics.merge_prometheus(pages)

    def _h_cluster_metrics(self, msg, frames):
        return {"text": self._cluster_metrics_text()}

    def _h_metrics_history(self, msg, frames):
        """The watchtower's retained time series (bounded ring buffers
        over the periodic cluster scrape). Read-only over state the
        sampling thread already gathered — this handler must NEVER call
        back into its own server's handler pool (the GL013 self-deadlock
        shape; the fan-out happened on the watchtower thread)."""
        return self.watchtower.history_dict(
            msg.get("names"), msg.get("window_s"))

    def _h_alerts(self, msg, frames):
        """Active alerts + bounded transition history + the rule pack.
        Same read-only discipline as metrics_history."""
        return self.watchtower.alerts_dict(
            include_history=msg.get("history", True))

    def _gather_cluster_logs(self, query: dict, timeout_s: float) -> dict:
        """One structured-log sweep: fan `log_query` out to every alive
        nodelet via call_gather (ONE shared deadline — a stopped node
        costs at most `timeout_s` and lands in `errors`, never fails
        the gather), merge the pages ts-sorted, thread per-node follow
        offsets through. Shared by the `cluster_logs` RPC handler and
        the watchtower's alert-context fetch (which runs on the
        watchtower thread — never back into this server's own pool,
        the GL013 shape)."""
        node_filter = query.get("node")
        with self._lock:
            targets = [(n.node_id.hex()[:12], n.address)
                       for n in self._nodes.values() if n.alive]
        if node_filter:
            targets = [(nid, a) for nid, a in targets
                       if nid.startswith(node_filter)]
        offsets = query.get("offsets") or {}
        limit = max(1, min(int(query.get("limit") or 1000), 5000))
        calls = []
        for nid, addr in targets:
            q = {k: query.get(k) for k in
                 ("level", "grep", "since", "until", "trace_id",
                  "task", "proc")}
            # the DEFAULTED limit, not the caller's raw value — a query
            # omitting "limit" must not ship limit=None to the nodelets
            q["limit"] = limit
            q["offsets"] = offsets.get(nid)
            calls.append((addr, "log_query", q))
        results = self.client.call_gather(calls, timeout=timeout_s)
        records: list[dict] = []
        errors: dict[str, str] = {}
        out_offsets: dict[str, dict] = {}
        truncated = False
        for (nid, _), r in zip(targets, results):
            if r is None:
                errors[nid] = ("log query failed, timed out, or node "
                               "unreachable")
                continue
            for rec in r.get("records", ()):
                rec.setdefault("node", nid)
                records.append(rec)
            out_offsets[nid] = r.get("offsets", {})
            truncated = truncated or bool(r.get("truncated"))
        records.sort(key=lambda r: r.get("ts", 0.0))
        if len(records) > limit:
            truncated = True
            records = records[-limit:]
        return {"records": records, "errors": errors,
                "offsets": out_offsets, "truncated": truncated}

    def _h_cluster_logs(self, msg, frames):
        from ray_tpu_torch.utils.logging import LEVELS

        level = msg.get("level")
        if level and str(level).lower() not in LEVELS:
            # level_no() ranks unknown names as info — fine for a
            # record, silently WIDENING as a filter; a raw-RPC caller's
            # typo must error like the CLI/state paths do
            raise ValueError(f"unknown level {level!r}")
        grep = msg.get("grep")
        if grep:
            # same discipline: a bad regex raised inside every
            # nodelet's log_query is indistinguishable from N dead
            # nodes
            import re as _re

            try:
                _re.compile(grep)
            except _re.error as e:
                raise ValueError(
                    f"invalid grep regex {grep!r}: {e}") from e
        timeout_s = max(1.0, min(float(msg.get("timeout") or 10.0),
                                 60.0))
        return self._gather_cluster_logs(msg, timeout_s)

    def _watchtower_log_context(self, n: int = 20) -> list[dict]:
        """Last N error-level lines cluster-wide — attached to firing
        alerts as bounded context (runs on the watchtower thread with a
        short budget; an unreachable node just thins the context)."""
        r = self._gather_cluster_logs(
            {"level": "error", "limit": n,
             "since": time.time() - 600.0}, timeout_s=3.0)
        return r["records"][-n:]

    def _h_profile_capture(self, msg, frames):
        """Cluster-wide capture: fan `profile_capture` out to every
        alive nodelet (which fans out to its workers) under ONE shared
        deadline while sampling the head's own process, and merge the
        node-tagged collapsed pages. The same fan-out shape as the
        metrics scrape — a dead node costs its timeout and a named
        entry in `errors`, never the capture."""
        from ray_tpu_torch.util import profiler

        duration = max(0.05, min(float(msg.get("duration_s", 5.0)),
                                 profiler.MAX_CAPTURE_S))
        hz = msg.get("hz")
        with self._lock:
            targets = [(n.node_id.hex()[:12], n.address)
                       for n in self._nodes.values() if n.alive]
        own = profiler.StackSampler(hz=hz).start()
        # a timer bounds the SELF-sample to exactly the capture window:
        # a hung nodelet parks call_gather for its full timeout, and an
        # unbounded own-sampler would then weigh the head ~(timeout/
        # duration)x heavier than every node page in the merged counts
        stopper = threading.Timer(duration, own.stop)
        stopper.daemon = True
        stopper.start()
        t0 = time.monotonic()
        try:
            results = self.client.call_gather(
                [(a, "profile_capture", {"duration_s": duration, "hz": hz})
                 for _, a in targets],
                timeout=duration + 15.0)
            rem = duration - (time.monotonic() - t0)
            if rem > 0:
                # stop-aware wait: shutdown ends the window early
                self._stopped.wait(rem)
        finally:
            stopper.cancel()
            own.stop()
        profiler._note_capture(own)
        pages = [profiler.prefix_stacks(own.collapsed(),
                                        "node:head;proc:head")]
        samples, dropped, procs = own.samples, own.stacks_dropped, 1
        errors: dict[str, str] = {}
        for (nid, _), r in zip(targets, results):
            if r is None:
                errors[nid] = "capture timed out or node unreachable"
                continue
            pages.append(profiler.prefix_stacks(r["stacks"], f"node:{nid}"))
            samples += r["samples"]
            dropped += r["dropped"]
            procs += r["procs"]
        return {"stacks": profiler.merge_collapsed(pages),
                "samples": samples, "dropped": dropped, "procs": procs,
                "errors": errors, "hz": own.hz, "duration_s": duration}

    def start_metrics_http(self, port: int = 0) -> int:
        """Serve the cluster-wide /metrics page over HTTP from the head
        (reference: the dashboard metrics endpoint). Returns the bound
        port."""
        from ray_tpu_torch.util.metrics import serve_metrics_http

        return serve_metrics_http(port, text_fn=self._cluster_metrics_text)

    def _h_list_actors(self, msg, frames):
        """State API source (reference: `ray list actors`,
        python/ray/util/state/api.py backed by the GCS actor table)."""
        with self._lock:
            out = []
            for aid, rec in self._actors.items():
                out.append({
                    "actor_id": aid.hex(),
                    "class_name": rec.spec.name or "",
                    "name": rec.spec.name,
                    "namespace": rec.spec.namespace,
                    "state": rec.state,
                    "address": rec.address,
                    "node_id": rec.node_id.hex() if rec.node_id else None,
                    "restarts_left": rec.restarts_left,
                    "death_cause": rec.death_cause,
                })
        return {"actors": out}

    # ------------------------------------------------------------ pubsub

    def _h_subscribe(self, msg, frames):
        """Push subscription (address fanout) or, with mode="poll", a
        LONG-POLL subscriber: the head buffers messages per subscriber id
        and poll_messages drains them — a briefly-unreachable subscriber
        loses nothing (reference: the long-poll publisher's per-subscriber
        mailboxes, src/ray/pubsub/publisher.h:297)."""
        if msg.get("mode") == "poll":
            sub_id = msg["subscriber_id"]
            with self._lock:
                from collections import deque

                box = self._poll_subs.setdefault(
                    sub_id, {"topics": set(), "queue": deque(maxlen=1000),
                             "cond": threading.Condition(self._lock),
                             "last_seen": time.monotonic()})
                box["topics"].update(msg["topics"])
            return {"subscribed": True}
        with self._lock:
            for t in msg["topics"]:
                self._subs.setdefault(t, set()).add(msg["address"])
        return {}

    def _h_poll_messages(self, msg, frames):
        """Long-poll drain: blocks until messages exist or the timeout
        lapses; returns the whole buffered batch."""
        sub_id = msg["subscriber_id"]
        timeout = min(float(msg.get("timeout", 10.0)), 25.0)
        with self._lock:
            box = self._poll_subs.get(sub_id)
            if box is None:
                return {"messages": [], "subscribed": False}
            box["last_seen"] = time.monotonic()
            if not box["queue"]:
                box["cond"].wait(timeout)
            if self._poll_subs.get(sub_id) is not box:
                # unsubscribed (or GC'd) while parked
                return {"messages": [], "subscribed": False}
            out = list(box["queue"])
            box["queue"].clear()
        return {"messages": out, "subscribed": True}

    def _h_unsubscribe(self, msg, frames):
        with self._lock:
            box = self._poll_subs.pop(msg.get("subscriber_id"), None)
            if box is not None:
                # wake any parked poll so its slow-lane thread frees now
                box["cond"].notify_all()
            for t in msg.get("topics", []):
                self._subs.get(t, set()).discard(msg.get("address"))
        return {}

    def _h_publish(self, msg, frames):
        self._publish(msg["topic"], msg["data"])

    def _publish(self, topic: str, data: dict):
        with self._lock:
            subs = list(self._subs.get(topic, ()))
            for box in self._poll_subs.values():
                if topic in box["topics"]:
                    box["queue"].append({"topic": topic, "data": data})
                    box["cond"].notify_all()
        for addr in subs:
            try:
                self.client.send_oneway(addr, "pubsub", {"topic": topic, "data": data})
            except Exception:
                pass

    # ------------------------------------------------------------ placement groups

    def _h_create_pg(self, msg, frames):
        from ray_tpu_torch.core.placement import create_pg
        with self._lock:
            nodes = [n for n in self._nodes.values() if n.alive]
            avail = dict(self._available)
        return create_pg(self, self._pgs, msg, nodes, avail)

    def _pg_retry_loop(self):
        """PENDING placement groups are replanned as the cluster changes
        (node added, resources released) — reference: the GCS keeps a
        pending queue and reschedules, gcs_placement_group_manager.h:228."""
        from ray_tpu_torch.core.placement import PGState, retry_pending_pgs

        while not self._stopped.wait(0.5):
            with self._lock:
                pending = [r for r in self._pgs.values()
                           if r.state == PGState.PENDING]
                if not pending:
                    continue
                nodes = [n for n in self._nodes.values() if n.alive]
                avail = dict(self._available)
            retry_pending_pgs(self, pending, nodes, avail)

    def _h_pg_table(self, msg, frames):
        from ray_tpu_torch.core.placement import pg_info
        with self._lock:
            return pg_info(self._pgs, msg.get("pg_id"))

    def _h_remove_pg(self, msg, frames):
        from ray_tpu_torch.core.placement import remove_pg
        return remove_pg(self, self._pgs, msg["pg_id"])


def dataclass_dict(dc) -> dict:
    import dataclasses
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def main():
    import argparse
    import os
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--address-file", required=True)
    args = ap.parse_args()
    head = Head().start()
    tmp = args.address_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(head.address)
    os.replace(tmp, args.address_file)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    head.stop()
    sys.exit(0)


if __name__ == "__main__":
    main()
