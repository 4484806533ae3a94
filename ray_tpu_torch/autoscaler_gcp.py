"""GCP TPU node provider — pod-slice autoscaling via queued resources.

Reference parity: autoscaler/_private/gcp/node.py:191 (GCPTPUNode /
queued-resource lifecycle), gcp/config.py:15 (accelerator-type →
slice shape), gcp/tpu_command_runner.py:1 (per-host fan-out of setup
commands across a pod slice). The GCP surface is mocked
(FakeTPUQueuedResourceAPI) because this image has zero egress — the
provider speaks the same request/state machine a real client would
(create → ACCEPTED → PROVISIONING → ACTIVE; delete is whole-slice
atomic), so swapping in the real REST client is a transport change,
not a redesign.

TPU-native semantics the generic provider lacks:
- the unit of creation/deletion is a SLICE (N hosts appear/vanish
  together, matching queued-resources atomicity);
- every host registers with slice-identity labels
  (ray.io/tpu-slice, ray.io/tpu-worker-id, pod type, topology) so
  slice-gang placement groups land on one slice in worker-id order;
- worker 0 asserts the `TPU-{pod_type}-head` marker resource.

The port's copy of ``ray_tpu/autoscaler_gcp.py``, as it is: the hosts
boot as the port's Nodelets with the port's ``core/tpu.py`` labels and
a ``TPU`` resource (no GPU counterpart), under the port's own root,
``$TMPDIR/ray_tpu_torch/gcp``.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any

from ray_tpu_torch.autoscaler import NodeProvider
from ray_tpu_torch.core import tpu as tpu_mod

_SESSION_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "gcp")


def slice_shape(accelerator_type: str) -> tuple[int, int]:
    """(num_hosts, chips_per_host) for an accelerator type like
    "v4-16". The numeric suffix counts TensorCores for v2/v3 (8 per
    host) and chips for v4+ (4 per host) — reference: gcp/config.py
    accelerator parsing + tpu.py pod-type arithmetic."""
    try:
        gen, n = accelerator_type.split("-", 1)
        n = int(n)
    except ValueError:
        raise ValueError(f"malformed accelerator_type {accelerator_type!r}")
    per_host = 8 if gen in ("v2", "v3") else 4
    return max(1, n // per_host), per_host if gen not in ("v2", "v3") else 4


# ------------------------------------------------------------ fake API

ACCEPTED = "ACCEPTED"
PROVISIONING = "PROVISIONING"
ACTIVE = "ACTIVE"
FAILED = "FAILED"
DELETING = "DELETING"


class FakeTPUQueuedResourceAPI:
    """In-memory double of the TPU queued-resources API: the same
    create/get/delete verbs and state machine, advancing one state per
    poll so tests drive provisioning deterministically."""

    def __init__(self, provision_polls: int = 2):
        self._qrs: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._provision_polls = provision_polls
        self._fail_next = 0
        self.create_calls = 0
        self.delete_calls = 0

    def fail_next_creations(self, n: int):
        """Inject provisioning failures (stockout) for the next n QRs."""
        with self._lock:
            self._fail_next = n

    def create_queued_resource(self, name: str, accelerator_type: str,
                               runtime_version: str = "tpu-ubuntu2204-base"):
        with self._lock:
            if name in self._qrs:
                raise ValueError(f"queued resource {name!r} already exists")
            hosts, chips = slice_shape(accelerator_type)
            fail = self._fail_next > 0
            if fail:
                self._fail_next -= 1
            self._qrs[name] = {
                "name": name,
                "accelerator_type": accelerator_type,
                "runtime_version": runtime_version,
                "state": ACCEPTED,
                "polls": 0,
                "will_fail": fail,
                "num_hosts": hosts,
                "chips_per_host": chips,
            }
            self.create_calls += 1
            return dict(self._qrs[name])

    def get_queued_resource(self, name: str) -> dict:
        with self._lock:
            qr = self._qrs.get(name)
            if qr is None:
                raise KeyError(name)
            if qr["state"] in (ACCEPTED, PROVISIONING):
                qr["polls"] += 1
                if qr["will_fail"]:
                    qr["state"] = FAILED
                elif qr["polls"] >= self._provision_polls:
                    qr["state"] = ACTIVE
                else:
                    qr["state"] = PROVISIONING
            if qr["state"] == ACTIVE and "hosts" not in qr:
                qr["hosts"] = [
                    {"worker_id": i,
                     "internal_ip": f"10.130.0.{i + 1}",
                     "hostname": f"{name}-w{i}"}
                    for i in range(qr["num_hosts"])
                ]
            return dict(qr)

    def delete_queued_resource(self, name: str):
        """Whole-slice atomic delete (all hosts vanish together)."""
        with self._lock:
            if name in self._qrs:
                self._qrs[name]["state"] = DELETING
                del self._qrs[name]
                self.delete_calls += 1

    def list_queued_resources(self) -> list[dict]:
        with self._lock:
            return [dict(q) for q in self._qrs.values()]


# ------------------------------------------------------------ provider


class _SliceHost:
    """One host of a provisioned slice; the autoscaler sees hosts, the
    provider deletes slices."""

    __slots__ = ("slice_name", "worker_id", "nodelet")

    def __init__(self, slice_name: str, worker_id: int, nodelet):
        self.slice_name = slice_name
        self.worker_id = worker_id
        self.nodelet = nodelet


class _PendingHost:
    """Placeholder for a host of a still-provisioning slice so the
    autoscaler's max_workers accounting sees in-flight capacity and
    does not over-launch."""

    __slots__ = ("slice_name",)

    def __init__(self, slice_name: str):
        self.slice_name = slice_name


class GCPTPUNodeProvider(NodeProvider):
    """NodeProvider over (fake) queued resources. node_types entries:
    {"accelerator_type": "v4-16", "cpus_per_host": 4, "topology": "2x2x2"}.

    In this image the "hosts" boot as in-process Nodelets (the same
    trick as FakeNodeProvider); a real deployment replaces _boot_host
    with a TPUCommandRunner-style SSH bootstrap per host (reference:
    gcp/tpu_command_runner.py fans one command out to every pod
    worker)."""

    def __init__(self, head_address: str, node_types: dict[str, dict],
                 api: FakeTPUQueuedResourceAPI | None = None,
                 session_dir: str = _SESSION_DIR):
        self.head_address = head_address
        self.node_types = node_types
        self.api = api or FakeTPUQueuedResourceAPI()
        self.session_dir = session_dir
        self._lock = threading.Lock()
        self._counter = 0
        self._pending: dict[str, dict] = {}  # slice -> node_type spec
        self._booting: dict[str, dict] = {}  # claimed by a poll(), booting
        self._slices: dict[str, list[_SliceHost]] = {}
        self.failed_slices: list[str] = []

    # -- NodeProvider surface -------------------------------------------

    def create_node(self, node_type: str):
        spec = self.node_types[node_type]
        with self._lock:
            self._counter += 1
            name = f"qr-{node_type}-{self._counter}"
        self.api.create_queued_resource(name, spec["accelerator_type"])
        with self._lock:
            self._pending[name] = spec
        return _PendingHost(name)

    def terminate_node(self, handle: Any):
        name = handle.slice_name
        self.api.delete_queued_resource(name)
        with self._lock:
            hosts = self._slices.pop(name, [])
            self._pending.pop(name, None)
            self._booting.pop(name, None)
        for h in hosts:  # whole-slice teardown, worker order irrelevant
            try:
                h.nodelet.stop()
            except Exception:  # noqa: BLE001
                pass

    def non_terminated_nodes(self) -> list:
        self.poll()
        out: list = []
        with self._lock:
            for hosts in self._slices.values():
                out.extend(hosts)
            for name, spec in {**self._pending, **self._booting}.items():
                n_hosts, _ = slice_shape(spec["accelerator_type"])
                out.extend(_PendingHost(name) for _ in range(n_hosts))
        return out

    def node_id(self, handle: Any) -> bytes:
        if isinstance(handle, _SliceHost):
            return handle.nodelet.node_id
        return b""  # pending: not in the head view yet

    # -- queued-resource reconciliation ---------------------------------

    def poll(self):
        """Advance pending slices; boot every host of a slice the moment
        it turns ACTIVE (hosts of one slice appear together)."""
        with self._lock:
            pending = list(self._pending.items())
        for name, spec in pending:
            try:
                qr = self.api.get_queued_resource(name)
            except KeyError:
                with self._lock:
                    self._pending.pop(name, None)
                continue
            if qr["state"] == FAILED:
                self.api.delete_queued_resource(name)
                with self._lock:
                    self._pending.pop(name, None)
                    self.failed_slices.append(name)
                continue
            if qr["state"] != ACTIVE:
                continue
            # CLAIM the slice under the lock BEFORE booting: concurrent
            # poll() callers (autoscaler loop + any non_terminated_nodes
            # caller) would otherwise each boot N nodelets and leak the
            # loser's set under duplicate slice/worker-id labels
            with self._lock:
                if self._pending.pop(name, None) is None:
                    continue  # another poll() claimed it
                self._booting[name] = spec  # still counted as capacity
            hosts = []
            for h in qr["hosts"]:
                hosts.append(self._boot_host(name, spec, qr, h))
            with self._lock:
                self._booting.pop(name, None)
                self._slices[name] = hosts

    def _boot_host(self, slice_name: str, spec: dict, qr: dict,
                   host: dict) -> _SliceHost:
        from ray_tpu_torch.core.nodelet import Nodelet

        wid = host["worker_id"]
        labels = {
            tpu_mod.SLICE_LABEL: slice_name,
            tpu_mod.WORKER_ID_LABEL: str(wid),
            tpu_mod.POD_TYPE_LABEL: spec["accelerator_type"],
        }
        if spec.get("topology"):
            labels[tpu_mod.TOPOLOGY_LABEL] = spec["topology"]
        resources = {
            "CPU": float(spec.get("cpus_per_host", 4)),
            "TPU": float(qr["chips_per_host"]),
        }
        resources.update(tpu_mod.head_marker_resources(labels))
        nl = Nodelet(self.head_address, resources, labels=labels,
                     session_dir=self.session_dir,
                     store_capacity=spec.get("store_capacity",
                                             64 * 1024 * 1024)).start()
        return _SliceHost(slice_name, wid, nl)
