"""Autoscaler — demand-driven node scaling over a pluggable provider.

Reference parity: the StandardAutoscaler loop
(autoscaler/_private/autoscaler.py:171) reading cluster load and asking
a NodeProvider (autoscaler/node_provider.py ABC) to launch/terminate
nodes; the fake multi-node provider (autoscaler/_private/fake_multi_node)
is the no-cloud test path. Scale-up signals: queued tasks with no
cluster-wide headroom and PENDING placement groups; scale-down: nodes
idle (full availability, empty queue) past idle_timeout. A TPU cloud
provider would implement NodeProvider with queued-resources / pod-slice
creation (reference: gcp/tpu_command_runner.py) — out of scope in this
zero-egress image.

The port's copy of ``ray_tpu/autoscaler.py``: `FakeNodeProvider` boots
the port's `Nodelet`, and its default session directory lies under
the port's own root, ``$TMPDIR/ray_tpu_torch/autoscaler``."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Any

_SESSION_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                            "autoscaler")


class NodeProvider:
    """ABC (reference: autoscaler/node_provider.py)."""

    def create_node(self, node_type: str) -> Any:
        raise NotImplementedError

    def terminate_node(self, handle: Any):
        raise NotImplementedError

    def non_terminated_nodes(self) -> list:
        raise NotImplementedError

    def node_id(self, handle: Any) -> bytes:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Launches in-process Nodelets against a head — the single-box test
    provider (reference: fake_multi_node)."""

    def __init__(self, head_address: str, node_types: dict[str, dict],
                 session_dir: str = _SESSION_DIR):
        self.head_address = head_address
        self.node_types = node_types
        self.session_dir = session_dir
        self._nodes: list = []

    def create_node(self, node_type: str):
        from ray_tpu_torch.core.nodelet import Nodelet

        spec = self.node_types[node_type]
        labels = dict(spec.get("labels", {}))
        # the demand scheduler's cross-pass per-type accounting reads
        # this label off registered nodes (and node_type off handles)
        labels.setdefault("ray_tpu.node_type", node_type)
        nl = Nodelet(self.head_address, dict(spec.get("resources", {})),
                     labels=labels,
                     session_dir=self.session_dir,
                     store_capacity=spec.get("store_capacity",
                                             64 * 1024 * 1024)).start()
        nl.node_type = node_type
        self._nodes.append(nl)
        return nl

    def terminate_node(self, handle):
        try:
            handle.stop()
        finally:
            if handle in self._nodes:
                self._nodes.remove(handle)

    def non_terminated_nodes(self) -> list:
        return list(self._nodes)

    def node_id(self, handle) -> bytes:
        return handle.node_id


def collect_demand_bundles(alive_nodes: list[dict],
                           pgs: list[dict]) -> list[dict]:
    """Demand SHAPES the cluster cannot currently place: each node's
    aggregate queued-task demand plus every bundle of a PENDING
    placement group (reference: load_metrics resource_load_by_shape +
    pending PG bundles feeding resource_demand_scheduler.py:102)."""
    bundles: list[dict] = []
    for n in alive_nodes:
        qd = {r: q for r, q in n.get("queued_demand", {}).items() if q > 0}
        if qd:
            bundles.append(qd)
    for g in pgs:
        if g.get("state") == "PENDING":
            bundles.extend(dict(b) for b in g.get("bundles", []))
    return bundles


class ResourceDemandScheduler:
    """Bin-pack unplaceable demand onto node TYPES (reference:
    autoscaler/_private/resource_demand_scheduler.py:102
    get_nodes_to_launch): first fill existing headroom, then open the
    cheapest node type that fits each remaining bundle (cost = the
    type's optional "cost" key; ties go to the least total capacity, so
    small demands don't launch big boxes)."""

    def __init__(self, node_types: dict[str, dict],
                 max_workers: int = 4):
        self.node_types = node_types
        self.max_workers = max_workers

    @staticmethod
    def _fits(avail: dict, bundle: dict) -> bool:
        return all(avail.get(r, 0.0) + 1e-9 >= q for r, q in bundle.items())

    @staticmethod
    def _deduct(avail: dict, bundle: dict):
        for r, q in bundle.items():
            avail[r] = avail.get(r, 0.0) - q

    def get_nodes_to_launch(self, demands: list[dict],
                            existing_headroom: list[dict],
                            existing_count: int,
                            existing_by_type: dict[str, int] | None = None
                            ) -> dict[str, int]:
        """demands: resource bundles with no current placement.
        existing_headroom: available-resources dicts of alive nodes.
        existing_by_type: running/booting node counts per type, so the
        per-type max_workers cap holds across reconcile passes (not just
        within one). Returns {node_type: count} to launch."""
        existing_by_type = existing_by_type or {}
        bins = [dict(h) for h in existing_headroom]
        virtual: list[tuple[str, dict]] = []  # (type, remaining)
        to_launch: dict[str, int] = {}
        budget = max(0, self.max_workers - existing_count)
        # largest-first packs tight (first-fit-decreasing)
        for bundle in sorted(demands,
                             key=lambda b: -sum(b.values())):
            placed = False
            for b in bins:
                if self._fits(b, bundle):
                    self._deduct(b, bundle)
                    placed = True
                    break
            if placed:
                continue
            for _, rem in virtual:
                if self._fits(rem, bundle):
                    self._deduct(rem, bundle)
                    placed = True
                    break
            if placed or sum(to_launch.values()) >= budget:
                continue
            candidates = [
                (spec.get("cost", 1.0),
                 sum(spec.get("resources", {}).values()), name)
                for name, spec in self.node_types.items()
                if self._fits(dict(spec.get("resources", {})), bundle)
                and to_launch.get(name, 0) +
                existing_by_type.get(name, 0) <
                spec.get("max_workers", self.max_workers)
            ]
            if not candidates:
                continue  # infeasible on every type: leave for the user
            _, _, best = min(candidates)
            rem = dict(self.node_types[best].get("resources", {}))
            self._deduct(rem, bundle)
            virtual.append((best, rem))
            to_launch[best] = to_launch.get(best, 0) + 1
        return to_launch


def compute_demand(alive_nodes: list[dict], pgs: list[dict]) -> bool:
    """The scale-up signal shared by the v1 loop and the v2 scheduler:
    queued work with no CPU headroom, or an unplaceable PENDING
    placement group."""
    total_queued = sum(n.get("queue_len", 0) for n in alive_nodes)
    headroom = sum(n.get("available", {}).get("CPU", 0.0)
                   for n in alive_nodes)
    pending_pgs = any(g.get("state") == "PENDING" for g in pgs)
    return (total_queued > 0 and headroom < 1.0) or pending_pgs


def idle_node_ids(alive_nodes: list[dict]) -> set:
    """Nodes with an empty queue and FULL availability. Tolerance
    compare: fractional acquire/release sequences can leave 1e-16-scale
    residue that exact equality never matches."""
    return {
        n["node_id"] for n in alive_nodes
        if n.get("queue_len", 0) == 0 and all(
            abs(n.get("available", {}).get(r, 0.0) - q) < 1e-6
            for r, q in n.get("resources", {}).items())
    }


@dataclasses.dataclass
class AutoscalerConfig:
    min_workers: int = 0
    max_workers: int = 4
    node_type: str = "worker"
    idle_timeout_s: float = 30.0
    poll_interval_s: float = 1.0
    upscaling_speed: int = 1  # nodes added per decision
    # heterogeneous mode: {type: {"resources": {...}, "cost": c,
    # "max_workers": m}} — demand bundles are bin-packed onto types by
    # the ResourceDemandScheduler instead of launching `node_type`
    node_types: dict | None = None


class StandardAutoscaler:
    def __init__(self, head_address: str, provider: NodeProvider,
                 config: AutoscalerConfig | None = None):
        from ray_tpu_torch.core.rpc import RpcClient

        self.head_address = head_address
        self.provider = provider
        self.config = config or AutoscalerConfig()
        self.client = RpcClient.shared()
        self._idle_since: dict[bytes, float] = {}
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self.num_launches = 0
        self.num_terminations = 0

    def start(self) -> "StandardAutoscaler":
        for _ in range(self.config.min_workers):
            self.provider.create_node(self.config.node_type)
            self.num_launches += 1
        self._thread.start()
        return self

    def stop(self):
        self._stopped.set()

    # -- one reconciliation pass (public for deterministic tests) --------

    def reconcile(self):
        cfg = self.config
        try:
            view = self.client.call(self.head_address, "cluster_view", {},
                                    timeout=10)["nodes"]
            pgs = self.client.call(self.head_address, "pg_table", {},
                                   timeout=10).get("groups", [])
        except Exception:  # noqa: BLE001
            return
        alive = [n for n in view if n["alive"]]
        managed = self.provider.non_terminated_nodes()

        if cfg.node_types:
            # heterogeneous path: pack unplaceable shapes onto types
            demands = collect_demand_bundles(alive, pgs)
            if demands:
                sched = ResourceDemandScheduler(cfg.node_types,
                                                cfg.max_workers)
                # per-type counts: registered nodes by label, launched-
                # but-not-yet-heartbeating ones by provider handle; take
                # the max per type so a node visible through both views
                # counts once
                by_label: dict[str, int] = {}
                for n in alive:
                    t = n.get("labels", {}).get("ray_tpu.node_type")
                    if t:
                        by_label[t] = by_label.get(t, 0) + 1
                by_handle: dict[str, int] = {}
                for h in managed:
                    t = (h.get("node_type") if isinstance(h, dict)
                         else getattr(h, "node_type", None))
                    if t:
                        by_handle[t] = by_handle.get(t, 0) + 1
                by_type = {t: max(by_label.get(t, 0), by_handle.get(t, 0))
                           for t in {*by_label, *by_handle}}
                plan = sched.get_nodes_to_launch(
                    demands, [n.get("available", {}) for n in alive],
                    len(managed), existing_by_type=by_type)
                for node_type, count in plan.items():
                    for _ in range(count):
                        self.provider.create_node(node_type)
                        self.num_launches += 1
                if plan:
                    return
            # fall through to reconcile_down timing
            return

        want_up = compute_demand(alive, pgs)
        if want_up and len(managed) < cfg.max_workers:
            n_new = min(cfg.upscaling_speed,
                        cfg.max_workers - len(managed))
            for _ in range(n_new):
                self.provider.create_node(cfg.node_type)
                self.num_launches += 1
            return  # let the new capacity register before judging idleness

    # -- scale-down (separate so tests can drive phases) -----------------

    def reconcile_down(self):
        cfg = self.config
        try:
            view = self.client.call(self.head_address, "cluster_view", {},
                                    timeout=10)["nodes"]
        except Exception:  # noqa: BLE001
            return
        by_id = {n["node_id"]: n for n in view}
        idle_ids = idle_node_ids([n for n in view if n["alive"]])
        now = time.monotonic()
        managed = self.provider.non_terminated_nodes()
        for handle in managed:
            if len(self.provider.non_terminated_nodes()) <= cfg.min_workers:
                break
            nid = self.provider.node_id(handle)
            n = by_id.get(nid)
            if n is None or not n["alive"]:
                continue
            if nid not in idle_ids:
                self._idle_since.pop(nid, None)
                continue
            t0 = self._idle_since.setdefault(nid, now)
            if now - t0 >= cfg.idle_timeout_s:
                self.provider.terminate_node(handle)
                self.num_terminations += 1
                self._idle_since.pop(nid, None)

    def _loop(self):
        while not self._stopped.wait(self.config.poll_interval_s):
            self.reconcile()
            self.reconcile_down()
