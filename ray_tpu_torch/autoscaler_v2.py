"""Autoscaler v2 — declarative instance lifecycle + reconciler.

Reference parity: python/ray/autoscaler/v2/ — the v2 redesign splits
the single scale loop into (a) a versioned INSTANCE STORAGE holding a
typed per-instance state machine (instance_manager/common.py:198 —
QUEUED → REQUESTED → ALLOCATED → RAY_RUNNING → TERMINATING →
TERMINATED, with failure edges), (b) a pure SCHEDULER that turns
cluster demand into desired instances (v2/scheduler.py), and (c) a
RECONCILER that converges storage ↔ cloud-provider ↔ ray-cluster views
idempotently every tick, with stuck-state timeouts
(instance_manager/reconciler.py). The v1 loop (`autoscaler.py`) stays
for simple deployments; v2 is the operator-grade path: every decision
is recorded as a versioned instance transition you can inspect, and a
crashed autoscaler resumes from storage instead of re-deriving state.

The same NodeProvider ABC drives both (create_node/terminate_node —
including GCPTPUNodeProvider's whole-slice semantics).

The port's copy of ``ray_tpu/autoscaler_v2.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Any, Callable

# ---------------------------------------------------------------- states

QUEUED = "QUEUED"  # demanded, not yet requested from the provider
REQUESTED = "REQUESTED"  # provider asked; waiting for the node
ALLOCATED = "ALLOCATED"  # provider says it exists; ray not up yet
RAY_RUNNING = "RAY_RUNNING"  # registered with the head, schedulable
TERMINATING = "TERMINATING"  # terminate issued; waiting for the provider
TERMINATED = "TERMINATED"  # gone (terminal)
ALLOCATION_FAILED = "ALLOCATION_FAILED"  # provider failure (terminal)

# legal transitions (reference: InstanceUtil.get_valid_transitions)
_TRANSITIONS: dict[str, set[str]] = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED, TERMINATING},
    ALLOCATED: {RAY_RUNNING, TERMINATING},
    RAY_RUNNING: {TERMINATING},
    TERMINATING: {TERMINATED},
    TERMINATED: set(),
    ALLOCATION_FAILED: set(),
}

# how long an instance may sit in a transient state before the
# reconciler declares it stuck (reference: reconciler timeouts)
DEFAULT_STUCK_TIMEOUTS_S = {
    REQUESTED: 120.0,
    ALLOCATED: 120.0,
    TERMINATING: 60.0,
}


class InvalidTransitionError(RuntimeError):
    pass


@dataclasses.dataclass
class Instance:
    """One managed node's lifecycle record (reference: the Instance
    proto in v2/schema)."""

    instance_id: str
    node_type: str
    status: str = QUEUED
    provider_handle: Any = None  # what the NodeProvider returned
    node_id: bytes | None = None  # once registered with the head
    version: int = 0
    status_since: float = dataclasses.field(default_factory=time.monotonic)
    history: list[tuple[str, float]] = dataclasses.field(
        default_factory=list)


class InstanceStorage:
    """Versioned in-memory instance table with update subscribers
    (reference: instance_storage.py — compare-and-swap updates so two
    reconciler passes can never interleave a transition)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: dict[str, Instance] = {}
        self._version = 0
        self._subscribers: list[Callable[[Instance], None]] = []

    def subscribe(self, fn: Callable[[Instance], None]):
        self._subscribers.append(fn)

    def add(self, node_type: str) -> Instance:
        inst = Instance(instance_id=uuid.uuid4().hex[:12],
                        node_type=node_type)
        with self._lock:
            self._version += 1
            inst.version = self._version
            inst.history.append((QUEUED, time.monotonic()))
            self._instances[inst.instance_id] = inst
            snap = self._snapshot(inst)
        self._notify(snap)
        return inst

    def transition(self, instance_id: str, new_status: str,
                   expected_version: int | None = None, **updates):
        """CAS state transition; raises on illegal edges so bugs surface
        as errors, not as silently-drifting state."""
        with self._lock:
            inst = self._instances.get(instance_id)
            if inst is None:
                raise KeyError(instance_id)
            if expected_version is not None and \
                    inst.version != expected_version:
                raise InvalidTransitionError(
                    f"version conflict on {instance_id}: "
                    f"{inst.version} != {expected_version}")
            if new_status not in _TRANSITIONS[inst.status]:
                raise InvalidTransitionError(
                    f"{inst.status} -> {new_status} is not a legal edge")
            inst.status = new_status
            inst.status_since = time.monotonic()
            inst.history.append((new_status, time.monotonic()))
            for k, v in updates.items():
                setattr(inst, k, v)
            self._version += 1
            inst.version = self._version
            snap = self._snapshot(inst)
        self._notify(snap)
        return inst

    @staticmethod
    def _snapshot(inst: Instance) -> Instance:
        """Immutable copy built UNDER the storage lock, so a concurrent
        transition can never tear the payload a subscriber receives.
        Cross-thread delivery order remains best-effort — consumers
        sort by .version."""
        return dataclasses.replace(inst, history=list(inst.history))

    def _notify(self, snap: Instance):
        for fn in self._subscribers:
            try:
                fn(snap)
            except Exception:  # noqa: BLE001
                pass

    def prune_terminal(self, keep: int = 200):
        """Drop the oldest terminal records past `keep` (a provider in
        persistent stockout would otherwise grow one ALLOCATION_FAILED
        record per tick, forever)."""
        with self._lock:
            terminal = [i for i in self._instances.values()
                        if i.status in (TERMINATED, ALLOCATION_FAILED)]
            terminal.sort(key=lambda i: i.status_since)
            for inst in terminal[:-keep] if keep else terminal:
                self._instances.pop(inst.instance_id, None)

    def list(self, *statuses: str) -> list[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if statuses:
            out = [i for i in out if i.status in statuses]
        return out

    def get(self, instance_id: str) -> Instance | None:
        with self._lock:
            return self._instances.get(instance_id)


# ---------------------------------------------------------------- scheduler


@dataclasses.dataclass
class SchedulingDecision:
    to_launch: dict[str, int]  # node_type -> count
    to_terminate: list[str]  # instance ids (idle past timeout)
    reason: str = ""


class Scheduler:
    """Pure function of (demand, live instances, config) → decision
    (reference: v2/scheduler.py ResourceDemandScheduler). Demand:
    queued work with no headroom or PENDING placement groups."""

    def __init__(self, node_type: str, min_workers: int, max_workers: int,
                 idle_timeout_s: float):
        self.node_type = node_type
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self._idle_since: dict[str, float] = {}

    def decide(self, demand: bool, instances: list[Instance],
               idle_node_ids: set[bytes]) -> SchedulingDecision:
        live = [i for i in instances
                if i.status in (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING)]
        n_live = len(live)
        to_launch: dict[str, int] = {}
        if n_live < self.min_workers:
            to_launch[self.node_type] = self.min_workers - n_live
        elif demand and n_live < self.max_workers:
            to_launch[self.node_type] = 1
        # idle scale-down: RAY_RUNNING instances whose node stayed idle
        # past the timeout, never below min_workers
        now = time.monotonic()
        to_terminate: list[str] = []
        running = [i for i in live if i.status == RAY_RUNNING]
        surplus = n_live - self.min_workers
        for inst in running:
            if inst.node_id not in idle_node_ids:
                self._idle_since.pop(inst.instance_id, None)
                continue
            t0 = self._idle_since.setdefault(inst.instance_id, now)
            if now - t0 >= self.idle_timeout_s and surplus > 0:
                to_terminate.append(inst.instance_id)
                self._idle_since.pop(inst.instance_id, None)
                surplus -= 1
        return SchedulingDecision(to_launch, to_terminate,
                                  reason="demand" if demand else "steady")


# ---------------------------------------------------------------- reconciler


class Reconciler:
    """Converges instance storage ↔ provider ↔ ray views each tick
    (reference: instance_manager/reconciler.py). Every step is
    idempotent: a second tick with unchanged inputs is a no-op."""

    def __init__(self, head_address: str, provider, node_type: str = "worker",
                 min_workers: int = 0, max_workers: int = 4,
                 idle_timeout_s: float = 30.0,
                 stuck_timeouts: dict[str, float] | None = None):
        from ray_tpu_torch.core.rpc import RpcClient

        self.head_address = head_address
        self.provider = provider
        self.storage = InstanceStorage()
        self.scheduler = Scheduler(node_type, min_workers, max_workers,
                                   idle_timeout_s)
        self.client = RpcClient.shared()
        # MERGE with defaults: a user tuning one state must not silently
        # disable the other stuck handlers
        self.stuck_timeouts = {**DEFAULT_STUCK_TIMEOUTS_S,
                               **(stuck_timeouts or {})}
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        # serializes manual reconcile() calls against the loop thread
        self._reconcile_lock = threading.Lock()
        self._launch_backoff_until = 0.0
        self.num_launches = 0
        self.num_terminations = 0

    # -- cluster views ---------------------------------------------------

    def _ray_view(self):
        view = self.client.call(self.head_address, "cluster_view", {},
                                timeout=10)["nodes"]
        pgs = self.client.call(self.head_address, "pg_table", {},
                               timeout=10).get("groups", [])
        return view, pgs

    # -- one idempotent pass --------------------------------------------

    def reconcile(self):
        """One idempotent pass; serialized so a manual call can never
        race the background loop into an illegal double-transition."""
        with self._reconcile_lock:
            self._reconcile_locked()

    def _reconcile_locked(self):
        from ray_tpu_torch.autoscaler import compute_demand, idle_node_ids

        try:
            view, pgs = self._ray_view()
        except Exception:  # noqa: BLE001
            return  # head unreachable: change nothing
        alive = [n for n in view if n["alive"]]
        by_node_id = {n["node_id"]: n for n in alive}
        try:
            provider_nodes = {self.provider.node_id(h): h
                              for h in self.provider.non_terminated_nodes()}
            provider_nodes.pop(b"", None)  # pending/booting placeholders
        except Exception:  # noqa: BLE001
            return  # provider unreachable: change nothing

        # 1. sync REQUESTED → ALLOCATED by matching UNCLAIMED provider
        # nodes (NOT the create handle: a GCP slice's create handle is a
        # placeholder and one create yields N hosts)
        claimed = {i.node_id for i in self.storage.list()
                   if i.node_id is not None}
        unclaimed = [nid for nid in provider_nodes if nid not in claimed]
        for inst in self.storage.list(REQUESTED):
            if not unclaimed:
                break
            nid = unclaimed.pop(0)
            self.storage.transition(inst.instance_id, ALLOCATED,
                                    node_id=nid,
                                    provider_handle=provider_nodes[nid])
        # 1b. ADOPT remaining unclaimed provider nodes (e.g. the extra
        # hosts of a pod slice — one create_node materialized N nodes;
        # reference: the reconciler adopts unknown cloud instances)
        for nid in unclaimed:
            inst = self.storage.add(self.scheduler.node_type)
            self.storage.transition(inst.instance_id, REQUESTED,
                                    provider_handle=provider_nodes[nid])
            self.storage.transition(inst.instance_id, ALLOCATED,
                                    node_id=nid)
        # 2. sync: ALLOCATED instances whose node registered with ray
        for inst in self.storage.list(ALLOCATED):
            if inst.node_id in by_node_id:
                self.storage.transition(inst.instance_id, RAY_RUNNING)
        # 2b. sync: RAY_RUNNING instances whose node DIED (crash,
        # preemption, or a whole-slice terminate taking sibling hosts):
        # without this they count as live forever and min_workers
        # replacement never fires
        for inst in self.storage.list(RAY_RUNNING):
            if inst.node_id not in by_node_id:
                self._terminate(inst)  # step 3 completes it next tick
        # 3. sync: TERMINATING instances gone from the provider
        for inst in self.storage.list(TERMINATING):
            if inst.node_id not in provider_nodes and \
                    inst.node_id not in by_node_id:
                self.storage.transition(inst.instance_id, TERMINATED)
                self.num_terminations += 1
        # 4. stuck-state handling (reference: reconciler timeouts)
        now = time.monotonic()
        for inst in self.storage.list(*self.stuck_timeouts):
            if now - inst.status_since <= self.stuck_timeouts[inst.status]:
                continue
            if inst.status == REQUESTED:
                if inst.provider_handle is not None:
                    # the provider call succeeded: the node may still
                    # materialize later — tear it down rather than leak
                    # a billing cloud resource behind a terminal record
                    self._terminate(inst)
                else:
                    self.storage.transition(inst.instance_id,
                                            ALLOCATION_FAILED)
            elif inst.status == ALLOCATED:
                # node exists but ray never came up: reclaim it
                self._terminate(inst)
            elif inst.status == TERMINATING:
                # retry the provider terminate; only force-complete the
                # record once the provider agrees the node is gone
                try:
                    if inst.provider_handle is not None:
                        self.provider.terminate_node(inst.provider_handle)
                except Exception:  # noqa: BLE001
                    pass
                if inst.node_id not in provider_nodes:
                    self.storage.transition(inst.instance_id, TERMINATED)
                    self.num_terminations += 1

        # 5. schedule against live demand (signals shared with v1)
        decision = self.scheduler.decide(
            compute_demand(alive, pgs), self.storage.list(),
            idle_node_ids(alive))
        # 6. apply: launches (QUEUED → REQUESTED with the provider call),
        # under a backoff after provider failures (a stockout must not
        # mint one failed record per tick forever)
        if decision.to_launch and now < self._launch_backoff_until:
            decision.to_launch = {}
        for node_type, count in decision.to_launch.items():
            for _ in range(count):
                inst = self.storage.add(node_type)
                try:
                    handle = self.provider.create_node(node_type)
                except Exception:  # noqa: BLE001
                    self.storage.transition(inst.instance_id, REQUESTED)
                    self.storage.transition(inst.instance_id,
                                            ALLOCATION_FAILED)
                    # stop the WHOLE tick's launches: hammering a
                    # stocked-out provider mints a failure per attempt
                    self._launch_backoff_until = now + 10.0
                    break
                self.storage.transition(inst.instance_id, REQUESTED,
                                        provider_handle=handle)
                self.num_launches += 1
            if now < self._launch_backoff_until:
                break
        # 7. apply: terminations
        for iid in decision.to_terminate:
            inst = self.storage.get(iid)
            if inst is not None and inst.status == RAY_RUNNING:
                self._terminate(inst)
        self.storage.prune_terminal()

    def _terminate(self, inst: Instance):
        self.storage.transition(inst.instance_id, TERMINATING)
        try:
            if inst.provider_handle is not None:
                self.provider.terminate_node(inst.provider_handle)
        except Exception:  # noqa: BLE001
            pass

    # -- lifecycle -------------------------------------------------------

    def start(self, interval_s: float = 1.0) -> "Reconciler":
        def loop():
            while not self._stopped.wait(interval_s):
                try:
                    self.reconcile()
                except Exception:  # noqa: BLE001
                    # one bad pass (transient provider/storage error)
                    # must not silently end autoscaling forever
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler-v2")
        self._thread.start()
        return self

    def stop(self):
        self._stopped.set()

    def summary(self) -> dict:
        """Operator view (reference: `ray status` v2 output)."""
        counts: dict[str, int] = {}
        for inst in self.storage.list():
            counts[inst.status] = counts.get(inst.status, 0) + 1
        return {"instances": counts, "launches": self.num_launches,
                "terminations": self.num_terminations}
