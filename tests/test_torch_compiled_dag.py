"""Compiled graphs on the port's cluster runtime, through the JAX
package's scenarios with their own inputs and assertions:
tests/test_compiled_dag.py (8) — bit-parity with the eager chain, a
multi-output fan, the head- and nodelet-free steady state, channel slots
reused and released, backpressure at max_inflight, concurrent executors
in seq order, and the two chaos cases (a mid-chain death failing like
the eager chain, a restartable stage replayed through the eager
fallback) — and the three DAG cases of tests/test_dag_offline_multiagent.py
(a chain with an error, a compiled graph beating per-call actor tasks
more than threefold, a multi-output fan). The JAX fixture's single
module-scoped runtime (``init(num_cpus=8)``, head and nodelet in this
process). Actor classes defined here travel by value."""

import gc
import glob
import os
import threading
import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core.exceptions import RayTpuError, TaskError
from ray_tpu_torch.dag import SLOT_PREFIX

# the port's channel slots (the JAX package's are dagc_*)
SLOTS = f"/dev/shm/{SLOT_PREFIX}*"


@pytest.fixture(scope="module")
def ray_boot():
    ray_tpu.init(num_cpus=8)
    yield ray_tpu
    ray_tpu.shutdown()


@ray_tpu.remote(num_cpus=0.2)
class Stage:
    def __init__(self, add):
        self.add = add

    def step(self, x):
        if x == "boom":
            raise ValueError("dag boom")
        return x + self.add

    def join(self, a, b):
        return a + b


def _chain_dag(actors):
    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        y = inp
        for a in actors:
            y = a.step.bind(y)
    return y


def _eager_chain(actors, x):
    ref = x
    for a in actors:
        ref = a.step.remote(ref)
    return ray_tpu.get(ref, timeout=60)


def test_bind_returns_class_method_node(ray_boot):
    """`actor.method.bind(node)` builds a graph node (the port's own
    case: it raised before compiled graphs were ported)."""
    from ray_tpu_torch.dag import ClassMethodNode, InputNode

    a = Stage.remote(1)
    try:
        with InputNode() as inp:
            node = a.step.bind(inp)
        assert isinstance(node, ClassMethodNode)
        assert node.method_name == "step" and node.upstream == [inp]
        assert node.actor_handle._actor_id == a._actor_id
        with pytest.raises(TypeError):
            a.step.bind(3)
    finally:
        ray_tpu.kill(a)


def test_bit_parity_with_eager_chain(ray_boot):
    """The gate: same inputs through compile().execute() and through
    the eager .remote() chain produce identical outputs, and a failing
    input raises the SAME TaskError with the same cause."""
    actors = [Stage.remote(i + 1) for i in range(3)]
    ray_tpu.get([a.step.remote(0) for a in actors])
    dag = _chain_dag(actors).compile()
    try:
        inputs = list(range(10)) + [-5, 1000000]
        compiled = [dag.execute(x).get() for x in inputs]
        eager = [_eager_chain(actors, x) for x in inputs]
        assert compiled == eager
        # error propagation parity: type, cause type, and message match
        with pytest.raises(TaskError) as ce:
            dag.execute("boom").get()
        with pytest.raises(TaskError) as ee:
            _eager_chain(actors, "boom")
        assert type(ce.value.cause) is type(ee.value.cause)
        assert str(ce.value.cause) == str(ee.value.cause) == "dag boom"
        # the pipeline stays aligned after an error slot
        assert dag.execute(7).get() == _eager_chain(actors, 7)
    finally:
        dag.teardown()
        for a in actors:
            ray_tpu.kill(a)


def test_multi_output_parity(ray_boot):
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    a, b = Stage.remote(10), Stage.remote(20)
    ray_tpu.get([a.step.remote(0), b.step.remote(0)])
    with InputNode() as inp:
        out = MultiOutputNode([a.step.bind(inp), b.step.bind(inp)])
    dag = out.compile()
    try:
        for x in (0, 3, 8):
            assert dag.execute(x).get() == ray_tpu.get(
                [a.step.remote(x), b.step.remote(x)], timeout=60)
    finally:
        dag.teardown()
        ray_tpu.kill(a)
        ray_tpu.kill(b)


def test_steady_state_skips_head_and_nodelet(ray_boot):
    """THE fast-path assertion: after compile, N executions cost ZERO
    head RPCs and ZERO nodelet scheduling RPCs — intermediate results
    flow worker→worker through the channel slots; the driver only
    touches shared memory. dag.execute spans record the attribution."""
    from ray_tpu_torch.core.api import _global_runtime

    rt = _global_runtime()
    head, nodelet = rt._booted[0], rt._booted[1]
    actors = [Stage.remote(1) for _ in range(2)]
    ray_tpu.get([a.step.remote(0) for a in actors])
    dag = _chain_dag(actors).compile()
    try:
        assert dag.execute(0).get() == 2  # pipeline warm
        rt._events.drain()  # start span capture fresh
        before_h = {m: s["count"]
                    for m, s in head.server.event_stats().items()}
        before_n = {m: s["count"]
                    for m, s in nodelet.server.event_stats().items()}
        n = 50
        refs = [dag.execute(i) for i in range(n)]
        assert [r.get() for r in refs] == [i + 2 for i in range(n)]
        after_h = head.server.event_stats()
        after_n = nodelet.server.event_stats()
        for m in ("get_actor", "create_actor", "kv_put", "kv_get"):
            assert after_h.get(m, {}).get("count", 0) == \
                before_h.get(m, 0), f"head rpc {m} on the compiled path"
        for m in ("schedule_task", "schedule_tasks", "request_lease",
                  "start_actor"):
            assert after_n.get(m, {}).get("count", 0) == \
                before_n.get(m, 0), f"nodelet rpc {m} on the compiled path"
        # the span plane still attributes every execution
        spans = rt._events.drain()
        dag_spans = [s for s in spans if s["cat"] == "dag"]
        assert len(dag_spans) >= n
    finally:
        dag.teardown()
        for a in actors:
            ray_tpu.kill(a)


def test_channel_slots_are_reused_and_released(ray_boot):
    """Compile allocates a FIXED set of channel slots; repeated
    execution mints no new segments, teardown unlinks every one."""
    actors = [Stage.remote(1) for _ in range(2)]
    ray_tpu.get([a.step.remote(0) for a in actors])
    before = set(glob.glob(SLOTS))
    dag = _chain_dag(actors).compile()
    created = set(glob.glob(SLOTS)) - before
    assert len(created) == 3  # input edge, a->b edge, output edge
    try:
        refs = [dag.execute(i) for i in range(100)]
        [r.get() for r in refs]
        assert set(glob.glob(SLOTS)) - before == created
    finally:
        dag.teardown()
        for a in actors:
            ray_tpu.kill(a)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and \
            set(glob.glob(SLOTS)) & created:
        time.sleep(0.05)
    assert not set(glob.glob(SLOTS)) & created, \
        "teardown leaked channel slots"


def test_backpressure_bounds_inflight(ray_boot):
    """A fast submitter cannot overrun a slow consumer: execute()
    blocks at max_inflight, results stay correct and ordered."""

    @ray_tpu.remote(num_cpus=0.2)
    class SlowStage:
        def step(self, x):
            time.sleep(0.02)
            return x * 2

    s = SlowStage.remote()
    ray_tpu.get(s.step.remote(0))
    dag = _chain_dag([s]).compile(max_inflight=4)
    try:
        n = 24
        seen_inflight = []
        done = threading.Event()

        def sample():
            while not done.is_set():
                seen_inflight.append(dag._seq - dag._fetched)
                time.sleep(0.005)

        t = threading.Thread(target=sample, daemon=True)
        t.start()
        refs = []

        def producer():
            for i in range(n):
                refs.append(dag.execute(i))

        p = threading.Thread(target=producer, daemon=True)
        p.start()
        out = []
        deadline = time.monotonic() + 30
        while len(out) < n and time.monotonic() < deadline:
            if len(refs) > len(out):
                out.append(refs[len(out)].get(timeout=30))
        done.set()
        p.join(timeout=10)
        t.join(timeout=2)
        assert out == [i * 2 for i in range(n)]
        assert max(seen_inflight) <= 4, \
            f"backpressure breached: {max(seen_inflight)} in flight"
    finally:
        dag.teardown()
        ray_tpu.kill(s)


def test_concurrent_executors_keep_seq_order(ray_boot):
    """Two threads calling execute() concurrently: channel writes are
    serialized in seq order, so every ref resolves to ITS input's
    result (a swapped write would silently cross the answers)."""

    @ray_tpu.remote(num_cpus=0.2)
    class Echo:
        def step(self, x):
            return x

    e = Echo.remote()
    ray_tpu.get(e.step.remote(0))
    dag = _chain_dag([e]).compile()
    try:
        results = {}
        lock = threading.Lock()

        def producer(base):
            for i in range(60):
                v = base + i
                r = dag.execute(v)
                with lock:
                    results[r._seq] = v

        ts = [threading.Thread(target=producer, args=(b,), daemon=True)
              for b in (0, 1000)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert len(results) == 120
        for seq, v in sorted(results.items()):
            assert CompiledDAGRefValue(dag, seq) == v
    finally:
        dag.teardown()
        ray_tpu.kill(e)


def CompiledDAGRefValue(dag, seq):
    from ray_tpu_torch.dag import CompiledDAGRef

    return CompiledDAGRef(dag, seq).get(timeout=60)


def test_chaos_mid_chain_death_falls_back_cleanly(ray_boot):
    """Kill the middle actor of a 3-stage chain with executions in
    flight: pending executions land through the eager fallback with
    the SAME error an eager chain raises (ActorDiedError for the dead
    stage), nothing hangs, and neither channel slots nor owned oids
    leak."""
    from ray_tpu_torch.core.api import _global_runtime

    rt = _global_runtime()
    actors = [Stage.remote(i + 1) for i in range(3)]
    ray_tpu.get([a.step.remote(0) for a in actors])
    gc.collect()
    time.sleep(0.3)  # let queued frees drain
    owned_before = len(rt._owned)
    shm_before = set(glob.glob(SLOTS))
    dag = _chain_dag(actors).compile()
    try:
        assert dag.execute(1).get() == 7
        ray_tpu.kill(actors[1])
        time.sleep(0.3)
        refs = [dag.execute(i) for i in range(4)]
        for r in refs:
            with pytest.raises(RayTpuError):
                # ActorDiedError (death seen at submit) or TaskError
                # wrapping it (death seen by the running call) — the
                # same surface the eager chain has
                r.get(timeout=30)
        assert dag._broken  # fallback engaged, channels abandoned
        # a LATER execute goes straight to the eager path and fails
        # identically — no hang, no desync
        with pytest.raises(RayTpuError):
            dag.execute(99).get(timeout=30)
        with pytest.raises((RayTpuError,)):
            _eager_chain(actors, 99)
    finally:
        dag.teardown()
        for a in (actors[0], actors[2]):
            ray_tpu.kill(a)
        ray_tpu.kill(actors[1], no_restart=True)
    # no leaked channel slots
    deadline = time.monotonic() + 5
    created = set(glob.glob(SLOTS)) - shm_before
    while time.monotonic() < deadline and created:
        time.sleep(0.05)
        created = set(glob.glob(SLOTS)) - shm_before
    assert not created, "chaos path leaked channel slots"
    # no stranded oids: the fallback's intermediate refs release once
    # their handles drop
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        gc.collect()
        if len(rt._owned) <= owned_before + 2:
            break
        time.sleep(0.1)
    assert len(rt._owned) <= owned_before + 2, \
        f"stranded oids: {len(rt._owned)} vs {owned_before}"


def _actor_state(handle):
    """Head's view of an actor: (state, address)."""
    from ray_tpu_torch.core.api import _global_runtime

    rt = _global_runtime()
    r = rt.client.call(rt.head_address, "get_actor",
                       {"actor_id": handle._actor_id.binary(),
                        "wait": False}, timeout=10)
    return r.get("state"), r.get("address")


def _await_actor_settled(handle, old_address, deadline_s=120.0):
    """Deterministic post-heal settle barrier (the ROADMAP-noted
    module-context-load flake: the old wait loop only proved ONE eager
    call landed, which can race the heal while the head still
    publishes the dying incarnation's address — the DAG's fallback
    probe then sees ALIVE at the OLD address and keeps polling its
    dead channels). Event-gate on the actual replay preconditions:
    the head reports the actor ALIVE at a NEW address, AND an eager
    call through the handle completes against that incarnation."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            state, address = _actor_state(handle)
        except Exception:  # noqa: BLE001  # head briefly busy under load
            time.sleep(0.2)
            continue
        if state == "ALIVE" and address and address != old_address:
            try:
                ray_tpu.get(handle.step.remote(0), timeout=30)
                return address
            except RayTpuError:
                pass  # replacement not serving yet (at-most-once race)
        time.sleep(0.2)
    raise TimeoutError("actor did not settle at a new incarnation "
                       f"within {deadline_s}s")


def test_chaos_restartable_actor_replays_through_fallback(ray_boot):
    """A restartable mid-chain actor: the heal plane republishes its
    routing and the eager fallback REPLAYS retained inputs through the
    restarted incarnation — executions complete with correct values.
    Post-heal execution is gated on `_await_actor_settled` (ALIVE at a
    NEW address + a served eager call) and the replay window is wide:
    under module-context load the respawn alone can take tens of
    seconds, and the old one-successful-call wait raced the routing
    republish."""
    a = Stage.remote(1)
    b = Stage.options(max_restarts=1).remote(10)
    c = Stage.remote(100)
    ray_tpu.get([a.step.remote(0), b.step.remote(0), c.step.remote(0)])
    _, b_addr0 = _actor_state(b)
    dag = _chain_dag([a, b, c]).compile()
    try:
        assert dag.execute(0).get() == 111
        ray_tpu.kill(b, no_restart=False)
        # settle barrier: the replacement incarnation is published AND
        # serving before the DAG replays through it
        _await_actor_settled(b, b_addr0)
        refs = [dag.execute(i) for i in range(3)]
        # the fallback resolves the restarted incarnation (stages are
        # stateless, so replay values match the compiled path exactly)
        assert [r.get(timeout=120) for r in refs] == [111 + i for i in
                                                     range(3)]
        assert dag._broken
    finally:
        dag.teardown()
        for x in (a, b, c):
            ray_tpu.kill(x)


# ------------------------------------- tests/test_dag_offline_multiagent.py


def test_compiled_dag_chain_and_errors(ray_boot):
    from ray_tpu_torch.dag import InputNode

    @ray_tpu.remote(num_cpus=0.5)
    class Stage:
        def __init__(self, add):
            self.add = add

        def step(self, x):
            if x == "boom":
                raise ValueError("dag boom")
            return x + self.add

    a, b = Stage.remote(1), Stage.remote(10)
    ray_tpu.get([a.step.remote(0), b.step.remote(0)])
    with InputNode() as inp:
        y = b.step.bind(a.step.bind(inp))
    dag = y.experimental_compile()
    try:
        assert dag.execute(5).get() == 16
        # pipelined executions come back in order
        refs = [dag.execute(i) for i in range(50)]
        assert [r.get() for r in refs] == [i + 11 for i in range(50)]
        # errors propagate through the pipeline to the caller — the
        # SAME TaskError the eager .remote() chain raises (bit-parity
        # gated in tests/test_compiled_dag.py)
        from ray_tpu_torch.core.exceptions import TaskError

        with pytest.raises(TaskError, match="boom"):
            dag.execute("boom").get()
    finally:
        dag.teardown()
        ray_tpu.kill(a)
        ray_tpu.kill(b)


def test_compiled_dag_beats_actor_calls(ray_boot):
    """The point of compiling: repeated execution costs channel ops, not
    per-call task submission (compiled_dag_node.py:711)."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu.remote(num_cpus=0.5)
    class Echo:
        def step(self, x):
            return x

    e = Echo.remote()
    ray_tpu.get(e.step.remote(0))
    with InputNode() as inp:
        y = e.step.bind(inp)
    dag = y.experimental_compile()
    try:
        n = 500
        t0 = time.perf_counter()
        refs = [dag.execute(i) for i in range(n)]
        assert [r.get() for r in refs] == list(range(n))
        dag_rate = n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        m = 200
        for i in range(m):
            ray_tpu.get(e.step.remote(i))
        call_rate = m / (time.perf_counter() - t0)
        assert dag_rate > 3 * call_rate, (dag_rate, call_rate)
    finally:
        dag.teardown()
        ray_tpu.kill(e)


def test_compiled_dag_multi_output(ray_boot):
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    @ray_tpu.remote(num_cpus=0.5)
    class Mul:
        def __init__(self, k):
            self.k = k

        def step(self, x):
            return x * self.k

    a, b = Mul.remote(2), Mul.remote(3)
    ray_tpu.get([a.step.remote(0), b.step.remote(0)])
    with InputNode() as inp:
        out = MultiOutputNode([a.step.bind(inp), b.step.bind(inp)])
    dag = out.experimental_compile()
    try:
        assert dag.execute(7).get() == [14, 21]
    finally:
        dag.teardown()
        ray_tpu.kill(a)
        ray_tpu.kill(b)


def test_teardown_skips_a_dead_stages_process(ray_boot):
    """The port's own case: once the liveness probe has found a stage's
    process gone, teardown() sends its address no stop call (that call
    waited out its 10 s timeout), and still releases every channel
    slot."""
    a = Stage.remote(1)
    ray_tpu.get(a.step.remote(0))
    _, a_addr0 = _actor_state(a)
    dag = _chain_dag([a]).compile()
    created = {c.name for c in dag._channels}
    try:
        assert dag.execute(0).get() == 1
        ray_tpu.kill(a)
        with pytest.raises(RayTpuError):
            dag.execute(5).get(timeout=60)
        assert dag._broken and dag._gone == {a_addr0}
    finally:
        t0 = time.monotonic()
        dag.teardown()
        took = time.monotonic() - t0
    assert took < 5.0, f"teardown took {took:.1f} s"
    assert not {os.path.basename(p) for p in glob.glob(SLOTS)} & created
