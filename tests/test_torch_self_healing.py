"""Self-healing Serve on the port's cluster runtime, through the JAX
package's scenarios with their own inputs and assertions:
tests/test_self_healing.py (9) — RPC delay injection, the controller's
health loop replacing a killed replica, unary failover through a
single replica's heal, the restart backoff and cap, affinity fallback,
an idle handle converging after a heal, and the LLM gate: 8 concurrent
greedy streams through a mid-generation replica kill, bit-identical to
the unkilled run, the replacement caught up to the fleet's weight
version, an update issued during the replacement window, and an RL
rollout riding the failover. One case of the port's own: Serve's
background paths boot no runtime after ``shutdown()``.

The LLM app is the JAX fixture's: tiny GPT-2 (vocab 64, one layer, two
heads, E=32) in float32, pages of 8 tokens, on the CPU
(``build_llm_app(device="cpu")``).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import chaos


def _failovers(app: str) -> float:
    from ray_tpu_torch.util.metrics import prometheus_text

    for line in prometheus_text().splitlines():
        if line.startswith(
                f'serve_request_failovers_total{{app="{app}"}}'):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _wait_healed(app: str, target: int, min_restarts: int = 1,
                 timeout: float = 120.0) -> dict:
    """Block until the app is back to `target` replicas with no
    replacement in flight (and at least `min_restarts` heals done)."""
    deadline = time.monotonic() + timeout
    hl: dict = {}
    while time.monotonic() < deadline:
        hl = serve.status()["health"].get(app, {})
        if hl.get("restarts", 0) >= min_restarts and \
                hl.get("healthy") == target and \
                hl.get("replacing") == 0:
            return hl
        time.sleep(0.3)
    raise AssertionError(f"{app} never healed: {hl}")


# ---------------------------------------------------------------------------
# RPC chaos: delay injection (no cluster)
# ---------------------------------------------------------------------------

def test_rpc_chaos_delay_injection():
    """"method=delayN" delivers the first N sends LATE (timer thread),
    so a caller with a shorter timeout sees exactly what a slow network
    produces: a timeout racing an in-flight straggler — then full speed
    once the budget is spent."""
    from ray_tpu_torch.core import rpc

    server = rpc.RpcServer(name="chaos-delay").start()
    server.register("slowmo", lambda msg, frames: {"ok": True})
    client = rpc.RpcClient()
    os.environ["RAY_TPU_TESTING_RPC_DELAY_S"] = "0.6"
    try:
        assert client.call(server.address, "slowmo", {},
                           timeout=10)["ok"]  # warm, undelayed
        rpc.set_chaos("slowmo=delay2")
        for _ in range(2):
            with pytest.raises(rpc.PeerUnavailableError):
                client.call(server.address, "slowmo", {}, timeout=0.2)
        t0 = time.monotonic()
        assert client.call(server.address, "slowmo", {},
                           timeout=10)["ok"]  # budget spent: fast again
        assert time.monotonic() - t0 < 0.5
        # a delayed send with a GENEROUS timeout still succeeds — the
        # message was late, not lost
        rpc.set_chaos("slowmo=delay1")
        t0 = time.monotonic()
        assert client.call(server.address, "slowmo", {},
                           timeout=10)["ok"]
        assert time.monotonic() - t0 >= 0.5
    finally:
        rpc.set_chaos("")
        os.environ.pop("RAY_TPU_TESTING_RPC_DELAY_S", None)
        client.close()
        server.stop()


def test_background_paths_boot_no_runtime_after_shutdown():
    """The port's own case (the JAX module lacks it): a push or a failover
    handled after shutdown() (the updater's refresh, a death report)
    must not boot a new runtime in the process, which the next user of
    the process would meet as "init() called twice"."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        c.wait_for_nodes()
        ray_tpu.init(address=c.address)

        @serve.deployment
        class Late:
            def __call__(self, x):
                return x

        h = serve.run(Late.bind(), name="late")
        assert ray_tpu.get(h.remote(1), timeout=60) == 1
        serve.shutdown()
    finally:
        ray_tpu.shutdown()
        c.shutdown()
    try:
        h._refresh_now()
        h._note_dead("0" * 32, "reported after shutdown")
        assert not ray_tpu.is_initialized()
    finally:
        ray_tpu.shutdown()  # what a regression booted


# ---------------------------------------------------------------------------
# cluster fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    # replica processes inherit this: one intra-op thread each (a
    # replica claims a tenth of a CPU), so their tiny engines do not
    # keep torch's spinning thread pool busy on every core of the host
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    try:
        c.wait_for_nodes()
        ray_tpu.init(address=c.address)
        yield c
        serve.shutdown()
    finally:
        ray_tpu.shutdown()
        c.shutdown()
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _tiny_llm_cfg():
    from ray_tpu_torch.models import gpt2

    return gpt2.GPT2Config(
        vocab_size=64, n_layer=1, n_head=2, n_embd=32, block_size=64,
        vocab_pad_multiple=64, dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def llm_app(cluster):
    """One 2-replica tiny LLM app shared by the LLM heal tests (they
    run in order; weight versions only ever move forward)."""
    from ray_tpu_torch.serve.llm import build_llm_app

    app = build_llm_app(
        model="gpt2",
        engine_config={"model_config": _tiny_llm_cfg(), "block_size": 8,
                       "num_blocks": 96, "max_model_len": 64,
                       "max_batch_size": 8, "prefill_chunk_size": 8},
        num_replicas=2, max_ongoing_requests=16, device="cpu")
    handle = serve.run(app, name="llm-heal")
    yield handle
    serve.delete("llm-heal")


def _tiny_llm_params(seed: int = 0):
    """The replicas' own params (an engine seeds its init with its
    config's seed, 0)."""
    from ray_tpu_torch.serve.llm.runner import adapters

    gen = torch.Generator().manual_seed(seed)
    return adapters()["gpt2"].init_fn(gen, _tiny_llm_cfg(), device="cpu")


# ---------------------------------------------------------------------------
# generic apps: heal loop, failover, backoff/cap, affinity, idle handles
# ---------------------------------------------------------------------------

def test_health_loop_replaces_killed_replica(cluster):
    """Kill → DEAD detection → routing-set removal → replacement, with
    the lifecycle history visible through serve_status()."""

    @serve.deployment(num_replicas=2, health_check_period_s=0.3)
    class Echo:
        def __call__(self, x):
            return ("ok", x)

    h = serve.run(Echo.bind(), name="heal")
    try:
        assert ray_tpu.get(h.remote(1), timeout=60) == ("ok", 1)
        ident = chaos.kill_replica("heal")
        # requests keep succeeding through the whole heal window
        for i in range(5):
            assert ray_tpu.get(h.remote(i), timeout=60) == ("ok", i)
            time.sleep(0.2)
        hl = _wait_healed("heal", target=2)
        assert not hl["degraded"], hl
        assert ident not in {r["ident"] for r in hl["replicas"]}, \
            "dead replica still in the routing set"
        events = [e["event"] for e in hl["lifecycle"]]
        assert "dead" in events and "replaced" in events, hl["lifecycle"]
        dead = [e for e in hl["lifecycle"] if e["event"] == "dead"][0]
        assert dead["replica"] == ident and dead["detail"]  # reason kept
        # the state-API face debug-dump persists shows the same thing
        from ray_tpu_torch.util.state import serve_status

        st = serve_status()
        assert st["health"]["heal"]["restarts"] >= 1
        # probe/restart metrics reached the controller's /metrics page
        from ray_tpu_torch.util.state import cluster_metrics

        text = cluster_metrics()
        assert "serve_replica_restarts_total" in text
        assert 'serve_replica_health_checks_total{app="heal"' in text
    finally:
        serve.delete("heal")


def test_unary_failover_single_replica_rides_out_heal(cluster):
    """ActorDiedError on a unary call is transparent: the relay retries
    with backoff until the replacement takes traffic — even when the
    dead replica was the ONLY one."""

    @serve.deployment(num_replicas=1, health_check_period_s=0.3)
    class Solo:
        def __call__(self, x):
            return x * 3

    h = serve.run(Solo.bind(), name="solo")
    try:
        assert ray_tpu.get(h.remote(2), timeout=60) == 6
        before = _failovers("solo")
        chaos.kill_replica("solo")
        # submitted into the outage window: must converge, not error
        assert ray_tpu.get(h.remote(5), timeout=120) == 15
        assert _failovers("solo") > before
        _wait_healed("solo", target=1)
    finally:
        serve.delete("solo")


def test_restart_backoff_cap_no_hot_loop(cluster, tmp_path):
    """A replica that crashes in __init__ repeatedly burns its
    max_replica_restarts budget and stops — degraded, not hot-looping."""
    sentinel = str(tmp_path / "crash-on-init")

    @serve.deployment(num_replicas=1, health_check_period_s=0.3,
                      max_replica_restarts=2)
    class Crashy:
        def __init__(self, path):
            if os.path.exists(path):
                raise RuntimeError("flagged to crash in __init__")
            self.path = path

        def __call__(self, x):
            return x

    h = serve.run(Crashy.bind(sentinel), name="crashy")
    try:
        assert ray_tpu.get(h.remote(7), timeout=60) == 7
        with open(sentinel, "w") as f:
            f.write("boom")
        chaos.kill_replica("crashy")
        deadline = time.monotonic() + 90
        hl = {}
        while time.monotonic() < deadline:
            hl = serve.status()["health"].get("crashy", {})
            if hl.get("degraded_reason"):
                break
            time.sleep(0.3)
        assert hl.get("degraded_reason"), hl
        assert "max_replica_restarts" in hl["degraded_reason"]
        assert hl["restart_attempts"] == 2  # the cap, exactly
        assert hl["healthy"] == 0 and hl["replacing"] == 0
        events = [e["event"] for e in hl["lifecycle"]]
        assert events.count("restart_failed") == 2
        assert "restart_cap" in events
        # no hot loop: attempts do not grow once the cap is hit
        time.sleep(2.0)
        hl2 = serve.status()["health"]["crashy"]
        assert hl2["restart_attempts"] == 2
        assert [e["event"] for e in hl2["lifecycle"]].count(
            "restart_failed") == 2
        # the app still exists (never flaps to deletion); an explicit
        # redeploy recovers it
        os.unlink(sentinel)
        h2 = serve.run(Crashy.bind(sentinel), name="crashy")
        assert ray_tpu.get(h2.remote(9), timeout=60) == 9
    finally:
        serve.delete("crashy")


def test_affinity_falls_back_when_primary_dies(cluster):
    """Rendezvous routing re-ranks over the LIVE set: when a key's
    chosen replica dies, the key deterministically lands on the
    next-ranked survivor instead of erroring."""
    import hashlib

    from ray_tpu_torch.serve.api import _replica_ident

    @serve.deployment(num_replicas=2, health_check_period_s=0.3)
    class Aff:
        def __init__(self):
            self.pid = os.getpid()

        def __call__(self, x):
            return self.pid

    h = serve.run(Aff.bind(), name="aff")
    try:
        replicas = chaos.list_replicas("aff")

        def score(key, r):
            return hashlib.blake2b(
                f"{key}:{_replica_ident(r)}".encode(),
                digest_size=8).digest()

        # a key whose rendezvous primary is replica 0
        key = next(f"k{i}" for i in range(64)
                   if max(replicas, key=lambda r: score(f"k{i}", r))
                   is replicas[0])
        pid_primary = ray_tpu.get(
            h.options(affinity_key=key).remote(0), timeout=60)
        chaos.kill_replica("aff", index=0)
        # routed during/after the outage: must land on the survivor
        pid_after = ray_tpu.get(
            h.options(affinity_key=key).remote(1), timeout=120)
        assert pid_after != pid_primary
        _wait_healed("aff", target=2)
    finally:
        serve.delete("aff")


def test_idle_handle_converges_after_heal(cluster):
    """A handle created before the kill and next used after the heal
    routes straight to the replacement — no submit to the dead
    replica's stub first. The push-refresh usually converges idle
    handles in <100ms, but pushes are best-effort oneways; the HARD
    bound is the anti-entropy window (_REFRESH_S): past it, the next
    call refreshes synchronously before picking, so this assertion is
    deterministic even if every push was lost."""

    @serve.deployment(num_replicas=2, health_check_period_s=0.3)
    class Idle:
        def __call__(self, x):
            return x + 1

    h = serve.run(Idle.bind(), name="idle")
    try:
        assert ray_tpu.get(h.remote(0), timeout=60) == 1  # primed
        chaos.kill_replica("idle")
        _wait_healed("idle", target=2)
        time.sleep(serve.api.DeploymentHandle._REFRESH_S + 0.5)
        before = _failovers("idle")
        for i in range(3):
            assert ray_tpu.get(h.remote(i), timeout=60) == i + 1
        assert _failovers("idle") == before, \
            "post-heal call still hit the dead replica's stub"
    finally:
        serve.delete("idle")


# ---------------------------------------------------------------------------
# the chaos gate: LLM streams survive a mid-generation replica kill
# ---------------------------------------------------------------------------

N_STREAMS, N_TOK = 8, 40


def _llm_prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(1, 64, size=6 + i).tolist()
            for i in range(N_STREAMS)]


def _run_streams(handle, prompts, on_second_event=None):
    """Consume N_STREAMS concurrently. With `on_second_event`, every
    consumer parks after its 2nd event until the hook has run — so the
    hook (the kill) fires while every stream is provably in flight
    (no final event delivered anywhere), regardless of box speed."""
    sh = handle.options(stream=True, generator_backpressure=8)
    results = [None] * len(prompts)
    errors: list = []
    barrier = (threading.Barrier(len(prompts) + 1, timeout=180)
               if on_second_event else None)
    resume = threading.Event()
    if on_second_event is None:
        resume.set()

    def consume(i, gen):
        try:
            evs = []
            for r in gen:
                evs.append(ray_tpu.get(r, timeout=180))
                if barrier is not None and len(evs) == 2:
                    barrier.wait()
                    resume.wait(timeout=180)
            results[i] = evs
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    gens = [sh.remote({"prompt": p, "max_tokens": N_TOK})
            for p in prompts]
    threads = [threading.Thread(target=consume, args=(i, g))
               for i, g in enumerate(gens)]
    for t in threads:
        t.start()
    if barrier is not None:
        barrier.wait()  # every stream has exactly 2 delivered events
        on_second_event()
        resume.set()
    for t in threads:
        t.join(timeout=300)
    return results, errors


def test_llm_kill_mid_stream_bit_identical_and_catchup(llm_app):
    """THE gate: 8 concurrent greedy streams, one replica killed
    mid-generation → zero failed requests, outputs bit-identical to the
    unkilled run, final events carry failover counts, and the
    replacement reports the fleet's current weight version before
    taking traffic."""
    prompts = _llm_prompts()

    # reference run (no chaos): both replicas share one weight seed, so
    # greedy outputs are replica-independent
    ref, errors = _run_streams(llm_app, prompts)
    assert not errors, errors
    want = [evs[-1]["token_ids"] for evs in ref]
    assert all(len(w) == N_TOK for w in want)

    # bump the fleet to weight version 1 (same values: outputs stay
    # comparable; the VERSION is what catch-up must preserve)
    out = llm_app.update_weights(1, _tiny_llm_params(0))
    assert {o.get("version") for o in out} == {1}

    killed = []
    results, errors = _run_streams(
        llm_app, prompts,
        on_second_event=lambda: killed.append(
            chaos.kill_replica("llm-heal", busiest=True)))
    assert not errors, f"client-visible failures: {errors}"
    failovers = 0
    for i, evs in enumerate(results):
        assert evs is not None, f"stream {i} never finished"
        final = evs[-1]
        toks = evs[:-1]
        # one seamless index sequence across the failover
        assert [e["index"] for e in toks] == list(range(len(toks)))
        assert [e["token"] for e in toks] == final["token_ids"]
        assert final["token_ids"] == want[i], \
            f"stream {i} diverged after failover"
        failovers += final.get("failovers", 0)
    assert failovers >= 1, "the kill never landed on an active stream"
    assert _failovers("llm-heal") >= failovers

    # the replacement entered the routing set at the current version
    hl = _wait_healed("llm-heal", target=2)
    assert hl["weight_version"] == 1
    assert killed and killed[0] not in \
        {r["ident"] for r in hl["replicas"]}
    from ray_tpu_torch.util.state import llm_status

    stats = llm_status("llm-heal")
    assert [s["weight_version"] for s in stats] == [1, 1], stats


def test_llm_update_weights_during_replacement_window(llm_app):
    """An update_weights broadcast issued while the replacement is
    still warming is NOT lost: the controller records it and replays it
    before the replacement enters the routing set."""
    from ray_tpu_torch.util.state import llm_status

    restarts0 = serve.status()["health"]["llm-heal"]["restarts"]
    chaos.kill_replica("llm-heal")
    time.sleep(0.1)  # inside the replacement window
    out = llm_app.update_weights(2, _tiny_llm_params(0))
    # the broadcast covers whatever the routing set held; the heal path
    # owns delivery to the replacement
    assert any(o.get("version") == 2 and "error" not in o or
               o.get("already_installed") for o in out) or out == []
    _wait_healed("llm-heal", target=2, min_restarts=restarts0 + 1)
    stats = llm_status("llm-heal")
    assert [s["weight_version"] for s in stats] == [2, 2], stats
    assert serve.status()["health"]["llm-heal"]["weight_version"] == 2


def test_rl_rollout_survives_replica_kill(llm_app):
    """The RL flywheel's rollout lap rides the same failover: kill an
    engine replica mid-rollout, every trajectory group completes and
    gets scored."""
    from ray_tpu_torch.rllib.llm.rollout import RolloutConfig, RolloutWorker

    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 64, size=8).tolist() for _ in range(4)]
    worker = RolloutWorker(
        handle=llm_app,
        reward_fn=lambda p, toks: float(len(toks)) / 32.0,
        config=RolloutConfig(group_size=2, max_tokens=24,
                             temperature=1.0))
    restarts0 = serve.status()["health"]["llm-heal"]["restarts"]
    # fires unconditionally: even a too-fast rollout leaves a kill for
    # _wait_healed to account for (no cancel — the heal must happen)
    killer = threading.Timer(
        0.3, lambda: chaos.kill_replica("llm-heal", busiest=True))
    killer.start()
    trajs = worker.rollout(prompts)
    killer.join(timeout=60)
    assert len(trajs) == 8
    assert all(len(t.tokens) > 0 and t.reward > 0 for t in trajs)
    _wait_healed("llm-heal", target=2, min_restarts=restarts0 + 1)
