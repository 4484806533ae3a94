"""The port's autoscaler v2 (ray_tpu_torch/autoscaler_v2.py) through the
scenarios of tests/test_autoscaler_v2.py (11): the instance storage's
state machine, and the reconciler against a live head of the port with
the fake and the GCP providers (one module-scoped cluster, a 1-CPU head
node, the JAX fixture's; each scenario tears down the nodes it made).
The state machine's histories and the scheduler's decisions are held
against the JAX package's on the same inputs. Functions are defined
inside the tests, so they travel by value. Every get carries a timeout.
"""

import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu import autoscaler_v2 as jax_v2
from ray_tpu_torch import autoscaler_v2
from ray_tpu_torch.autoscaler import FakeNodeProvider
from ray_tpu_torch.autoscaler_v2 import (
    ALLOCATED,
    ALLOCATION_FAILED,
    QUEUED,
    RAY_RUNNING,
    REQUESTED,
    TERMINATED,
    TERMINATING,
    InstanceStorage,
    InvalidTransitionError,
    Reconciler,
)
from ray_tpu_torch.cluster_utils import Cluster


# ---------------------------------------------------------------------------
# storage state machine
# ---------------------------------------------------------------------------

def test_legal_lifecycle_and_history():
    st = InstanceStorage()
    inst = st.add("worker")
    assert inst.status == QUEUED
    st.transition(inst.instance_id, REQUESTED)
    st.transition(inst.instance_id, ALLOCATED, node_id=b"n1")
    st.transition(inst.instance_id, RAY_RUNNING)
    st.transition(inst.instance_id, TERMINATING)
    got = st.transition(inst.instance_id, TERMINATED)
    assert [s for s, _ in got.history] == [
        QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, TERMINATING, TERMINATED]


def test_illegal_edges_raise():
    st = InstanceStorage()
    inst = st.add("worker")
    with pytest.raises(InvalidTransitionError):
        st.transition(inst.instance_id, RAY_RUNNING)  # QUEUED -> RUNNING
    st.transition(inst.instance_id, REQUESTED)
    st.transition(inst.instance_id, ALLOCATION_FAILED)
    with pytest.raises(InvalidTransitionError):
        st.transition(inst.instance_id, REQUESTED)  # terminal


def test_version_cas_conflict():
    st = InstanceStorage()
    inst = st.add("worker")
    v = inst.version
    st.transition(inst.instance_id, REQUESTED, expected_version=v)
    with pytest.raises(InvalidTransitionError):
        st.transition(inst.instance_id, ALLOCATED, expected_version=v)


def test_subscribers_see_every_transition():
    st = InstanceStorage()
    seen = []
    st.subscribe(lambda i: seen.append(i.status))
    inst = st.add("worker")
    st.transition(inst.instance_id, REQUESTED)
    assert seen == [QUEUED, REQUESTED]


# ---------------------------------------------------------------------------
# reconciler against a live head + fake provider
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


@pytest.fixture
def reconcilers(cluster):
    """The reconcilers a scenario makes; their nodes go when it ends, and
    the head has seen them die before the next scenario starts on the
    bare head (no task of it may be placed on a dying node)."""
    from ray_tpu_torch.core.rpc import RpcClient

    made = []
    yield made
    for rec in made:
        for h in list(rec.provider.non_terminated_nodes()):
            try:
                rec.provider.terminate_node(h)
            except Exception:  # noqa: BLE001
                pass
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        view = RpcClient.shared().call(cluster.address, "cluster_view", {},
                                       timeout=10)["nodes"]
        if sum(n["alive"] for n in view) == 1:
            break
        time.sleep(0.2)


def _mk(cluster, tmp_path, reconcilers, **kw):
    provider = FakeNodeProvider(
        cluster.address, {"worker": {"resources": {"CPU": 4.0}}},
        session_dir=str(tmp_path / "v2"))
    rec = Reconciler(cluster.address, provider, node_type="worker", **kw)
    reconcilers.append(rec)
    return rec


def test_scale_up_converges_to_ray_running(cluster, tmp_path,
                                            reconcilers):
    rec = _mk(cluster, tmp_path, reconcilers, min_workers=1, max_workers=3)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        rec.reconcile()
        if rec.storage.list(RAY_RUNNING):
            break
        time.sleep(0.2)
    running = rec.storage.list(RAY_RUNNING)
    assert len(running) == 1
    assert running[0].node_id is not None
    assert rec.summary()["launches"] == 1
    # idempotence: further ticks change nothing at steady state
    for _ in range(3):
        rec.reconcile()
    assert rec.summary()["launches"] == 1
    assert len(rec.storage.list(RAY_RUNNING)) == 1


def test_demand_drives_scale_up_then_idle_scale_down(cluster, tmp_path,
                                                        reconcilers):
    rec = _mk(cluster, tmp_path, reconcilers, min_workers=0, max_workers=2,
              idle_timeout_s=1.5)

    @ray_tpu.remote(num_cpus=1)
    def slow():
        time.sleep(1.0)
        return 1

    refs = [slow.remote() for _ in range(6)]  # 1-CPU head: queue builds
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        rec.reconcile()
        if rec.storage.list(RAY_RUNNING):
            break
        time.sleep(0.2)
    assert rec.storage.list(RAY_RUNNING), "no scale-up under demand"
    assert ray_tpu.get(refs, timeout=120) == [1] * 6

    # reclaim: RAY_RUNNING → TERMINATING → (provider+head agree it is
    # gone, head death-detection ~5s) → TERMINATED
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        rec.reconcile()
        if rec.storage.list(TERMINATED):
            break
        time.sleep(0.3)
    assert not rec.storage.list(RAY_RUNNING), "idle node never reclaimed"
    assert rec.storage.list(TERMINATED), "termination never converged"
    assert rec.summary()["terminations"] >= 1


def test_stuck_requested_instance_reclaimed_not_leaked(cluster, tmp_path):
    """A stuck REQUESTED whose provider call SUCCEEDED must be
    terminated (the cloud node may materialize later and bill forever
    behind a terminal record), not marked ALLOCATION_FAILED."""
    terminated = []

    class StuckProvider(FakeNodeProvider):
        def create_node(self, node_type):
            return object()  # a handle that never yields a node_id

        def node_id(self, handle):
            return b""

        def terminate_node(self, handle):
            terminated.append(handle)

    provider = StuckProvider(
        cluster.address, {"worker": {"resources": {"CPU": 2.0}}},
        session_dir=str(tmp_path / "stuck"))
    rec = Reconciler(cluster.address, provider, node_type="worker",
                     min_workers=1, max_workers=2,
                     stuck_timeouts={"REQUESTED": 0.5})
    rec.reconcile()
    assert rec.storage.list(REQUESTED)
    time.sleep(0.7)
    rec.reconcile()  # stuck → TERMINATING (terminate issued)
    rec.reconcile()  # provider agrees it is gone → TERMINATED
    assert terminated, "stuck launch never terminated at the provider"
    assert rec.storage.list(TERMINATED)
    assert not rec.storage.list(ALLOCATION_FAILED)
    # a partial stuck_timeouts override must keep the other defaults
    assert "ALLOCATED" in rec.stuck_timeouts
    assert "TERMINATING" in rec.stuck_timeouts


def test_provider_create_failure_records_allocation_failed(cluster,
                                                          tmp_path):
    class FailingProvider(FakeNodeProvider):
        def create_node(self, node_type):
            raise RuntimeError("stockout")

    provider = FailingProvider(
        cluster.address, {"worker": {"resources": {"CPU": 2.0}}},
        session_dir=str(tmp_path / "fail"))
    rec = Reconciler(cluster.address, provider, node_type="worker",
                     min_workers=1, max_workers=2)
    rec.reconcile()
    assert rec.storage.list(ALLOCATION_FAILED)
    assert not rec.storage.list(RAY_RUNNING)


def test_gcp_slice_adoption(cluster, tmp_path):
    """One GCP create_node yields N slice hosts; the reconciler matches
    the requesting instance to one host and ADOPTS the others as
    managed instances (reference: reconciler cloud-instance adoption)."""
    from ray_tpu_torch.autoscaler_gcp import GCPTPUNodeProvider

    provider = GCPTPUNodeProvider(
        cluster.address,
        {"tpu": {"accelerator_type": "v4-8", "cpus_per_host": 1}},
        session_dir=str(tmp_path / "gcpv2"))
    rec = Reconciler(cluster.address, provider, node_type="tpu",
                     min_workers=1, max_workers=4)
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        rec.reconcile()
        if len(rec.storage.list(RAY_RUNNING)) >= 2:
            break
        time.sleep(0.3)
    running = rec.storage.list(RAY_RUNNING)
    assert len(running) == 2, rec.summary()  # both v4-8 hosts managed
    assert len({i.node_id for i in running}) == 2
    assert rec.summary()["launches"] == 1  # ONE provider request
    for h in list(provider.non_terminated_nodes()):
        provider.terminate_node(h)


def test_stockout_backoff_bounds_failed_records(cluster, tmp_path):
    class FailingProvider(FakeNodeProvider):
        def create_node(self, node_type):
            raise RuntimeError("stockout")

    provider = FailingProvider(
        cluster.address, {"worker": {"resources": {"CPU": 2.0}}},
        session_dir=str(tmp_path / "stockout"))
    rec = Reconciler(cluster.address, provider, node_type="worker",
                     min_workers=1, max_workers=2)
    for _ in range(10):
        rec.reconcile()
    # backoff: 10 ticks produce ONE failed record, not ten
    assert len(rec.storage.list(ALLOCATION_FAILED)) == 1


def test_dead_ray_running_node_replaced(cluster, tmp_path, reconcilers):
    """A RAY_RUNNING instance whose node dies must leave RAY_RUNNING
    (via TERMINATING) so min_workers replacement fires — a crashed node
    must not count as live capacity forever."""
    rec = _mk(cluster, tmp_path, reconcilers, min_workers=1, max_workers=3)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        rec.reconcile()
        if rec.storage.list(RAY_RUNNING):
            break
        time.sleep(0.2)
    inst = rec.storage.list(RAY_RUNNING)[0]
    inst.provider_handle.stop()  # kill the nodelet behind the provider's back
    rec.provider._nodes.remove(inst.provider_handle)
    deadline = time.monotonic() + 40
    replaced = False
    while time.monotonic() < deadline:
        rec.reconcile()
        running = rec.storage.list(RAY_RUNNING)
        if running and running[0].instance_id != inst.instance_id:
            replaced = True
            break
        time.sleep(0.3)
    assert replaced, rec.summary()
    assert rec.summary()["launches"] == 2


# ---------------------------------------------------------------------------
# the state machine and the scheduler against the JAX package's
# ---------------------------------------------------------------------------

_STATES = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, TERMINATING,
           TERMINATED, ALLOCATION_FAILED)


def _drive_storage(mod, seed: int) -> list:
    """Seeded transitions (some illegal, some with a stale version)
    through one package's InstanceStorage: what each did, and every
    instance's history of states."""
    import numpy as np

    rng = np.random.default_rng(seed)
    st = mod.InstanceStorage()
    ids = [st.add("worker").instance_id for _ in range(4)]
    out = []
    for _ in range(40):
        iid = ids[int(rng.integers(len(ids)))]
        to = _STATES[int(rng.integers(len(_STATES)))]
        inst = st.get(iid)
        stale = bool(rng.integers(4) == 0)
        try:
            got = st.transition(iid, to, expected_version=(
                inst.version - 1 if stale else inst.version))
            out.append(("ok", got.status))
        except mod.InvalidTransitionError:
            out.append(("refused", inst.status, to, stale))
    out.append([[s for s, _ in st.get(i).history] for i in ids])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_state_machine_histories_match_jax(seed):
    assert _drive_storage(autoscaler_v2, seed) == _drive_storage(jax_v2,
                                                                 seed)


def _decide(mod, demand: bool, statuses, idle: set, lo: int, hi: int):
    sched = mod.Scheduler("worker", lo, hi, idle_timeout_s=0.0)
    insts = [mod.Instance(instance_id=f"i{k}", node_type="worker",
                          status=s, node_id=f"n{k}".encode())
             for k, s in enumerate(statuses)]
    d = sched.decide(demand, insts, idle)
    return d.to_launch, d.to_terminate, d.reason


@pytest.mark.parametrize("demand", [False, True])
@pytest.mark.parametrize("statuses,idle,lo,hi", [
    ((), set(), 1, 3),
    ((RAY_RUNNING,), {b"n0"}, 0, 2),
    ((RAY_RUNNING, RAY_RUNNING, REQUESTED), {b"n0", b"n1"}, 1, 3),
    ((QUEUED, ALLOCATED, TERMINATING, TERMINATED), set(), 2, 4),
    ((RAY_RUNNING,) * 3, {b"n0", b"n1", b"n2"}, 3, 3),
])
def test_scheduler_decisions_match_jax(demand, statuses, idle, lo, hi):
    assert _decide(autoscaler_v2, demand, statuses, idle, lo, hi) == \
        _decide(jax_v2, demand, statuses, idle, lo, hi)
