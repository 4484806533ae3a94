"""Latency attribution plane: per-request serve waterfalls, per-step
train waterfalls, span sampling + head spill, the one-call flight
recorder, and the metric-catalog drift gate — the scenarios of
tests/test_observability4.py (15) on the port, and beside them:

- the tiny engine of the JAX scenarios built in both packages from the
  JAX parameters (carried across by ``interop``): the port's breakdown
  keys equal JAX's on the same requests, and its greedy streams equal
  JAX's with the request traced under a root span and without;
- the port's attributed train step (GPT-2 tiny, float32, on the CPU):
  its phases and its ``train.step.*`` spans sum to the step time within
  the JAX scenario's 5 %;
- the drift gate against the JAX package: the port's scanner finds
  every metric JAX registers but the named deviations
  (``metrics_catalog.DEVIATIONS``), the docs check reads
  OBSERVABILITY.md less those, and the dashboard check the committed
  dashboards/ray_tpu.json's timeseries panels less those (the JAX
  scenario regenerates that file with ``devtools.grafana``, not ported
  yet).

The train waterfall runs on one device (the JAX scenario's runs on an
8-device CPU mesh; the port's mesh needs a process group a rank).
"""

import dataclasses
import json
import os
import re
import time

import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.utils.events import TaskEventLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# per-request serve.llm waterfall
# ---------------------------------------------------------------------------

_ENGINE_KW = dict(model="gpt2", block_size=8, num_blocks=64,
                  max_model_len=64, max_batch_size=4,
                  prefill_chunk_size=8, seed=0)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX scenario's tiny GPT-2 and its seed-0 params, as numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2

    cfg = jgpt2.GPT2Config(
        vocab_size=64, n_layer=1, n_head=2, n_embd=32, block_size=64,
        vocab_pad_multiple=64, dtype=jnp.float32, remat=False)
    params = jgpt2.init_gpt2(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree.map(np.asarray, params)


def _tiny_engine(jax_params, **overrides):
    import torch

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = gpt2.GPT2Config(
        vocab_size=64, n_layer=1, n_head=2, n_embd=32, block_size=64,
        vocab_pad_multiple=64, dtype=torch.float32, remat=False)
    kw = dict(_ENGINE_KW, model_config=cfg)
    kw.update(overrides)
    return LLMEngine(EngineConfig(**kw),
                     params=interop.params_from_jax(jax_params[1]),
                     device="cpu")


@pytest.fixture(scope="module")
def engine(jax_params):
    return _tiny_engine(jax_params)


@pytest.fixture(scope="module")
def jax_engine(jax_params):
    from ray_tpu.serve.llm import EngineConfig, LLMEngine

    return LLMEngine(EngineConfig(model_config=jax_params[0], **_ENGINE_KW),
                     params=jax_params[1])


def test_request_breakdown_sums_to_e2e(engine):
    from ray_tpu_torch.serve.llm.config import SamplingParams

    t0 = time.monotonic()
    final = engine.generate(list(range(1, 11)),
                            SamplingParams(max_tokens=8), drive=True)
    wall = time.monotonic() - t0
    bd = final["breakdown"]
    assert final["finish_reason"] == "length"
    # the acceptance contract: phases sum to within 5% of e2e latency
    phase_sum = sum(v for k, v in bd.items() if k != "e2e")
    assert bd["e2e"] > 0
    assert abs(phase_sum - bd["e2e"]) <= 0.05 * bd["e2e"], bd
    # and the reported e2e is the request's real wall time
    assert abs(bd["e2e"] - wall) <= 0.05 * wall + 0.01, (bd, wall)
    # the work phases exist and dominate for a compute-bound request
    assert bd.get("prefill", 0) > 0 and bd.get("decode", 0) > 0, bd
    # cumulative per-phase totals surface through engine stats (the
    # llm_status() face of the same numbers)
    st = engine.stats()
    assert st["finished_requests"] >= 1
    assert st["phase_seconds"].get("decode", 0) > 0


def test_request_waterfall_child_spans_recorded(engine):
    from ray_tpu_torch.serve.llm.config import SamplingParams
    from ray_tpu_torch.util import tracing

    with tracing.span("obs4-root") as root:
        final = engine.generate([1, 2, 3, 4], SamplingParams(max_tokens=3),
                                drive=True)
    assert final["breakdown"]["e2e"] > 0
    spans = tracing._fallback_log.chrome_trace()
    req = [e for e in spans if e["name"] == "llm.request"
           and e.get("args", {}).get("trace_id") == root["trace_id"]]
    assert req, "llm.request span missing (or not under the root trace)"
    phases = [e for e in spans if e["name"].startswith("llm.request.")
              and e.get("args", {}).get("trace_id") == root["trace_id"]]
    names = {e["name"] for e in phases}
    assert {"llm.request.prefill", "llm.request.decode"} <= names, names
    # children are laid inside the parent's window, in waterfall order
    parent = req[-1]
    last_end = parent["ts"] - 50.0
    for e in sorted(phases, key=lambda e: e["ts"]):
        assert e["ts"] >= last_end - 50.0  # 50us float slack
        last_end = e["ts"] + e["dur"]
    assert last_end <= parent["ts"] + parent["dur"] + 1e3


def test_slo_metrics_exposed(engine):
    from ray_tpu_torch.serve.llm.config import SamplingParams
    from ray_tpu_torch.util.metrics import prometheus_text

    engine.generate([5, 6, 7], SamplingParams(max_tokens=4), drive=True)
    text = prometheus_text()
    assert 'serve_slo_ttft_ms_count{model="gpt2",phase="queue"}' in text
    assert 'serve_slo_ttft_ms_count{model="gpt2",phase="prefill"}' in text
    assert 'serve_slo_ttft_ms_count{model="gpt2",phase="total"}' in text
    assert "serve_slo_tpot_ms_count" in text


def test_breakdown_greedy_output_unchanged(engine, jax_params):
    """Attribution must not perturb generation: same prompt, same
    greedy tokens as an engine without a single breakdown consumer."""
    from ray_tpu_torch.serve.llm.config import SamplingParams

    a = engine.generate([9, 8, 7, 6], SamplingParams(max_tokens=6),
                        drive=True)
    b = _tiny_engine(jax_params).generate([9, 8, 7, 6],
                                SamplingParams(max_tokens=6), drive=True)
    assert a["token_ids"] == b["token_ids"]


def test_breakdown_keys_match_jax(engine, jax_engine):
    """The same request through both packages' engines: the same greedy
    tokens, the same breakdown phases, each summing to its e2e within
    the JAX scenario's 5 %."""
    from ray_tpu.serve.llm.config import SamplingParams as JaxSP
    from ray_tpu_torch.serve.llm.config import SamplingParams

    want = jax_engine.generate(list(range(1, 11)), JaxSP(max_tokens=8),
                               drive=True)
    got = engine.generate(list(range(1, 11)), SamplingParams(max_tokens=8),
                          drive=True)
    assert got["token_ids"] == want["token_ids"]
    assert set(got["breakdown"]) == set(want["breakdown"])
    for bd in (got["breakdown"], want["breakdown"]):
        phase_sum = sum(v for k, v in bd.items() if k != "e2e")
        assert abs(phase_sum - bd["e2e"]) <= 0.05 * bd["e2e"], bd


def test_greedy_streams_match_jax_traced_and_untraced(engine, jax_engine):
    """Spans change no token: the port's greedy stream under a root
    span, and with no trace at all, equals the JAX engine's."""
    from ray_tpu.serve.llm.config import SamplingParams as JaxSP
    from ray_tpu_torch.serve.llm.config import SamplingParams
    from ray_tpu_torch.util import tracing

    prompt = [9, 8, 7, 6, 5]
    want = jax_engine.generate(prompt, JaxSP(max_tokens=6),
                               drive=True)["token_ids"]
    with tracing.span("obs4-greedy") as root:
        traced = engine.generate(prompt, SamplingParams(max_tokens=6),
                                 drive=True)["token_ids"]
    assert tracing.current_trace() is None
    plain = engine.generate(prompt, SamplingParams(max_tokens=6),
                            drive=True)["token_ids"]
    assert traced == plain == want
    assert any(e["name"] == "llm.request"
               and e.get("args", {}).get("trace_id") == root["trace_id"]
               for e in tracing._fallback_log.chrome_trace())


# ---------------------------------------------------------------------------
# per-step train waterfall
# ---------------------------------------------------------------------------

def _tiny_train():
    """GPT-2 tiny in float32 on the CPU: a seed-0 state, a batch and the
    instrumented step."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss, init_gpt2
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.spmd import TrainState, make_train_step

    cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    tx = optim.sgd(0.01)
    state = TrainState.create(
        init_gpt2(torch.Generator().manual_seed(0), cfg, device="cpu"), tx)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 33)).astype(np.int64)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
    return state, batch, step


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny step's time is then its own, not
    the share of the cores other test processes leave it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_waterfall_sums_to_step_time(one_thread):
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util import tracing

    state, batch, step = _tiny_train()
    spmd.enable_step_waterfall()
    try:
        # two warmup steps, as the JAX scenario's (the port compiles
        # nothing; they keep the timed window's first step warm)
        state, m = step(state, batch)
        state, m = step(state, batch)
        spmd.waterfall.reset()
        n0 = len(tracing._fallback_log.chrome_trace())
        t0 = time.perf_counter()
        for _ in range(5):
            with spmd.data_wait():
                time.sleep(0.002)
            state, m = step(state, batch)
        dt = time.perf_counter() - t0
    finally:
        spmd.enable_step_waterfall(False)

    s = spmd.waterfall.summary()
    assert s["steps"] == 5
    # acceptance: attributed phases sum to within 5% of measured time
    assert abs(s["total_seconds"] - dt) <= 0.05 * dt, (s, dt)
    assert s["phases"].get("compute", 0) > 0
    assert s["phases"].get("data_wait", 0) >= 0.005
    assert "compile" not in s["phases"]  # the port compiles nothing
    # the attribution table: percents sum ~100
    pct = sum(s["percent"].values())
    assert 99.0 <= pct <= 101.0
    table = spmd.waterfall.table()
    assert "compute" in table and "%" in table
    # the laid-out train.step.* spans cover the window but the host gap
    spans = [e for e in tracing._fallback_log.chrome_trace()[n0:]
             if e.get("name", "").startswith("train.step.")]
    assert {e["name"] for e in spans} == {
        "train.step.data_wait", "train.step.h2d", "train.step.compute"}
    span_s = sum(e["dur"] for e in spans) / 1e6
    host = s["phases"].get("host", 0.0)
    assert abs(span_s + host - dt) <= 0.05 * dt, (span_s, host, dt)


def test_train_waterfall_off_by_default():
    import torch

    from ray_tpu_torch.train import optim, spmd
    from ray_tpu_torch.train.spmd import TrainState, make_train_step

    assert spmd.waterfall.enabled is False
    before = spmd.waterfall.steps
    tx = optim.sgd(0.1)
    s0 = TrainState.create({"w": torch.zeros(4)}, tx)
    step = make_train_step(
        lambda p, b: torch.sum((p["w"] - b["x"]) ** 2), tx)
    step(s0, {"x": torch.ones(4)})
    assert spmd.waterfall.steps == before  # nothing accumulated


# ---------------------------------------------------------------------------
# span sampling + counters
# ---------------------------------------------------------------------------

def test_sampling_keeps_first_per_name_and_counts_drops():
    log = TaskEventLog(capacity=10_000)
    log.configure_sampling({"max_per_s": 1.0})
    pairs = [("alpha", "cat1"), ("beta", "cat1"), ("gamma", "cat2")]
    n_each = 50
    t = time.monotonic_ns()
    for i in range(n_each):
        for name, cat in pairs:
            log.record(name, cat, t, t + 1000)
    events = log.drain()
    kept, dropped = log.span_counts()
    # >= 1 span survived per (category, name) — the hard guarantee
    seen = {(e["cat"], e["name"]) for e in events}
    assert {(c, n) for n, c in pairs} <= seen
    # everything else was dropped AND counted (nothing silent)
    total = n_each * len(pairs)
    assert sum(kept.values()) == len(events)
    assert sum(kept.values()) + sum(dropped.values()) == total
    assert dropped.get("cat1", 0) > 0 and dropped.get("cat2", 0) > 0
    # counters reach the metrics registry via the flush-loop sync
    log.sync_metrics()
    from ray_tpu_torch.util.metrics import prometheus_text

    text = prometheus_text()
    assert 'spans_dropped_total{category="cat1"}' in text
    assert 'spans_sampled_total{category="cat2"}' in text


def test_sampling_off_means_no_drops():
    log = TaskEventLog(capacity=100)
    t = time.monotonic_ns()
    for i in range(50):
        log.record(f"s{i}", "c", t, t + 10)
    kept, dropped = log.span_counts()
    assert sum(kept.values()) == 50 and not dropped
    # buffer overflow IS counted even without a sampling policy
    for i in range(100):
        log.record(f"o{i}", "c", t, t + 10)
    kept, dropped = log.span_counts()
    assert sum(dropped.values()) == 50 - len(log.drain()) + 100


def test_span_policy_rpc_auto_rate_limit():
    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.core.rpc import RpcClient

    head = Head(span_rate_limit=100.0).start()
    try:
        c = RpcClient.shared()
        assert c.call(head.address, "span_policy", {},
                      timeout=10)["policy"] is None
        # flood past the cap: the head starts handing out shares
        t = time.time() * 1e6
        spans = [{"name": f"s{i}", "cat": "task", "ph": "X", "ts": t,
                  "dur": 1.0, "proc": "w1"} for i in range(3000)]
        c.call(head.address, "dump_timeline", {"spans": spans},
               timeout=10)
        policy = c.call(head.address, "span_policy", {},
                        timeout=10)["policy"]
        assert policy is not None and policy["max_per_s"] <= 100.0
        # operator policy wins over automatic mode
        head.set_span_policy({"categories": {"task": 5.0}})
        policy = c.call(head.address, "span_policy", {},
                        timeout=10)["policy"]
        assert policy == {"categories": {"task": 5.0}}
    finally:
        head.stop()


# ---------------------------------------------------------------------------
# head spill round-trip
# ---------------------------------------------------------------------------

def test_head_spill_roundtrips_through_timeline(tmp_path):
    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.util import state

    head = Head(span_capacity=100,
                span_spill_dir=str(tmp_path / "spill")).start()
    try:
        t = time.time() * 1e6
        batches = [
            [{"name": f"span-{b}-{i}", "cat": "task", "ph": "X",
              "ts": t + b * 1000 + i, "dur": 5.0, "node": "n1",
              "proc": "w1", "tid": 1} for i in range(50)]
            for b in range(10)  # 500 spans vs a 100-span window
        ]
        from ray_tpu_torch.core.rpc import RpcClient

        for batch in batches:
            RpcClient.shared().call(head.address, "dump_timeline",
                                    {"spans": batch}, timeout=10)
        tl = state.cluster_timeline(address=head.address)
        names = {e["name"] for e in tl if e.get("ph") == "X"}
        # the EARLIEST spans fell out of the memory window but came
        # back from the spill; the latest are still in memory
        assert "span-0-0" in names, "spilled span lost"
        assert "span-9-49" in names
        assert sum(1 for e in tl if e.get("ph") == "X") == 500
        assert head._span_spill.spilled_total >= 400
        # and the spill directory is real bounded JSONL
        files = os.listdir(tmp_path / "spill")
        assert any(f.endswith(".jsonl") for f in files)
    finally:
        head.stop()


# ---------------------------------------------------------------------------
# flight recorder on a live (then degraded) cluster
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster2():
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "resources": {"o4a": 2.0}})
    c.add_node(num_cpus=4, resources={"o4b": 2.0})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


def test_debug_dump_collects_every_artifact(cluster2, tmp_path):
    from ray_tpu_torch.util import state

    @ray_tpu.remote(num_cpus=0.1)
    def obs4_task():
        return ray_tpu.get_runtime_context().node_id.hex()

    ray_tpu.get([obs4_task.remote() for _ in range(3)], timeout=60)
    out = state.debug_dump(out_dir=str(tmp_path / "dump"), deadline_s=60)
    files = set(os.listdir(out))
    for expected in ("summary.json", "nodes.json", "actors.json",
                     "tasks.json", "objects.json",
                     "placement_groups.json", "memory.txt",
                     "metrics.prom", "timeline.json", "serve_status.json",
                     "logs"):
        assert expected in files, (expected, files)
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    core = {"nodes", "actors", "tasks", "objects", "placement_groups",
            "memory", "metrics", "timeline", "serve_status"}
    assert core <= set(summary["artifacts"]), summary
    with open(os.path.join(out, "nodes.json")) as f:
        nodes = json.load(f)
    assert len(nodes) == 2
    # both nodes' logs were tailed
    assert len(os.listdir(os.path.join(out, "logs"))) == 2
    with open(os.path.join(out, "metrics.prom")) as f:
        assert 'node="' in f.read()
    with open(os.path.join(out, "timeline.json")) as f:
        assert isinstance(json.load(f), list)


def test_debug_dump_degraded_cluster_respects_deadline(cluster2,
                                                       tmp_path):
    """LAST test in the module: it stops a node. The dump must finish
    inside its deadline (plus write slack) and still produce the
    artifacts the surviving node can answer for."""
    from ray_tpu_torch.util import state

    victim = cluster2.nodelets[-1]
    cluster2.remove_node(victim)
    deadline = 45.0
    t0 = time.monotonic()
    out = state.debug_dump(out_dir=str(tmp_path / "degraded"),
                           deadline_s=deadline)
    elapsed = time.monotonic() - t0
    assert elapsed < deadline + 10.0, elapsed
    files = set(os.listdir(out))
    assert {"summary.json", "nodes.json", "timeline.json"} <= files
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert "nodes" in summary["artifacts"]


# ---------------------------------------------------------------------------
# drift gate: source == catalog == docs == dashboard
# ---------------------------------------------------------------------------

def _docs_metric_names() -> set[str]:
    """Metric names declared in OBSERVABILITY.md's catalog table (the
    first column's backticked tokens, tag annotations stripped)."""
    names: set[str] = set()
    with open(os.path.join(REPO, "OBSERVABILITY.md")) as f:
        for line in f:
            if not line.startswith("| `"):
                continue
            # split on table pipes only (tag values escape theirs: \|)
            first_col = re.split(r"(?<!\\)\|", line)[1]
            for tok in re.findall(r"`([^`]+)`", first_col):
                tok = tok.split("{", 1)[0].strip()
                if re.fullmatch(r"[a-z][a-z0-9_]+", tok):
                    names.add(tok)
    return names


def test_metric_catalog_matches_source():
    from ray_tpu_torch.util.metrics_catalog import CATALOG, source_metrics

    src = source_metrics()
    cat = {m["name"]: m["type"] for m in CATALOG}
    assert set(src) == set(cat), (
        f"registered-but-uncataloged: {set(src) - set(cat)}; "
        f"cataloged-but-unregistered: {set(cat) - set(src)}")
    for name, mtype in src.items():
        assert cat[name] == mtype, (name, mtype, cat[name])


def test_port_registers_every_jax_metric_but_the_deviations():
    """The scanner over ray_tpu_torch/ finds every metric the JAX
    package registers, less the named deviations, and nothing more."""
    from ray_tpu.util import metrics_catalog as jcat
    from ray_tpu_torch.util.metrics_catalog import DEVIATIONS, source_metrics

    jax_src = jcat.source_metrics()
    port_src = source_metrics()
    assert set(DEVIATIONS) <= set(jax_src)
    assert set(port_src) == set(jax_src) - set(DEVIATIONS), (
        set(jax_src) - set(DEVIATIONS) - set(port_src),
        set(port_src) - set(jax_src))
    for name, mtype in port_src.items():
        assert jax_src[name] == mtype, name


def test_metric_catalog_matches_docs():
    from ray_tpu_torch.util.metrics_catalog import DEVIATIONS, catalog_names

    docs = _docs_metric_names() - set(DEVIATIONS)
    cat = catalog_names()
    assert cat - docs == set(), f"undocumented metrics: {cat - docs}"
    assert docs - cat == set(), f"stale docs rows: {docs - cat}"


def test_dashboard_matches_catalog():
    """The committed dashboard's timeseries panels, less the named
    deviations, are the port's catalog (the JAX scenario also
    regenerates the file with ``devtools.grafana``, not ported yet)."""
    from ray_tpu_torch.util.metrics_catalog import DEVIATIONS, catalog_names

    path = os.path.join(REPO, "dashboards", "ray_tpu.json")
    with open(path) as f:
        committed = f.read()
    panels = {p["title"] for p in json.loads(committed)["panels"]
              if p["type"] == "timeseries"}
    assert set(DEVIATIONS) <= panels
    assert panels - set(DEVIATIONS) == catalog_names()
