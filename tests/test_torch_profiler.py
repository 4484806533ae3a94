"""Profiler plane: in-process stack sampler, cluster-wide `profile`
capture fan-out, per-task CPU attribution, memory attribution + the
stranded-ref auditor, and the watchtower rule that pages on stranded
bytes — the scenarios of tests/test_profiler.py (13) on the port, with
its two-node cluster; and `merge_collapsed`, `prefix_stacks` and
`collapsed_text` held against the JAX package's on seeded stacks.

`_p5_busy` is defined at the top of this module, as in JAX, so it
travels by reference: the workers import this module."""

import gc
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.util import profiler


# ---------------------------------------------------------------------------
# sampler units (no cluster)
# ---------------------------------------------------------------------------

def _p5_leaf(stop):
    while not stop.is_set():
        sum(range(64))


def _p5_mid(stop):
    _p5_leaf(stop)


def test_sampler_captures_stacks_root_first():
    stop = threading.Event()
    t = threading.Thread(target=_p5_mid, args=(stop,), daemon=True)
    t.start()
    s = profiler.StackSampler(hz=200).start()
    time.sleep(0.4)
    s.stop()
    stop.set()
    t.join(timeout=5)
    assert s.samples >= 10
    stacks = s.collapsed()
    hits = [k for k in stacks if ":_p5_mid" in k and ":_p5_leaf" in k]
    assert hits, f"busy thread's stack missing from {list(stacks)[:5]}"
    # root-first: the caller appears before the callee in every hit
    for k in hits:
        assert k.index(":_p5_mid") < k.index(":_p5_leaf")
    # the sampler excludes its own thread
    assert not any("stack-sampler" in k or "_run" in k.split(";")[-1]
                   for k in stacks if "profiler.py" in k.split(";")[-1])


def test_sampler_unique_stack_cap_counts_drops():
    stops = [threading.Event() for _ in range(3)]
    fns = [_p5_leaf, _p5_mid,
           lambda st: [time.sleep(0.01) for _ in iter(lambda: st.is_set(), True)]]
    threads = [threading.Thread(target=f, args=(st,), daemon=True)
               for f, st in zip(fns, stops)]
    for t in threads:
        t.start()
    s = profiler.StackSampler(hz=100, max_unique_stacks=1).start()
    time.sleep(0.3)
    s.stop()
    for st in stops:
        st.set()
    assert len(s.collapsed()) == 1  # the cap held
    assert s.stacks_dropped > 0  # and the overflow was COUNTED


def test_sampler_dormant_and_armed_overhead_gate():
    # dormant: no sampler thread exists at all
    assert not any(t.name == "stack-sampler"
                   for t in threading.enumerate())
    stop = threading.Event()
    t = threading.Thread(target=_p5_leaf, args=(stop,), daemon=True)
    t.start()
    window = 1.0
    s = profiler.StackSampler().start()  # default 25Hz
    time.sleep(window)
    s.stop()
    stop.set()
    t.join(timeout=5)
    # the overhead contract: the sampler's own measured CPU cost stays
    # under 2% of the armed window (thread_time is deterministic under
    # cgroup throttling, unlike a wall-clock A/B on this box)
    assert s.cpu_seconds < 0.02 * window, (
        f"sampler burned {s.cpu_seconds:.4f}s CPU in a {window}s window")
    # and dormant again after the window
    assert not any(th.name == "stack-sampler"
                   for th in threading.enumerate())


def test_collapsed_merge_prefix_text_and_chrome():
    a = {"f1;f2": 3, "f1;f3": 1}
    b = {"f1;f2": 2}
    merged = profiler.merge_collapsed([
        profiler.prefix_stacks(a, "node:n1;proc:w1"),
        profiler.prefix_stacks(b, "node:n1;proc:w1"),
        profiler.prefix_stacks(b, "node:n2;proc:w2"),
    ])
    assert merged["node:n1;proc:w1;f1;f2"] == 5  # identical stacks sum
    assert merged["node:n2;proc:w2;f1;f2"] == 2
    text = profiler.collapsed_text(merged)
    lines = text.strip().splitlines()
    assert lines[0] == "node:n1;proc:w1;f1;f2 5"  # heaviest first
    assert all(" " in ln and ln.rsplit(" ", 1)[1].isdigit()
               for ln in lines)
    events = profiler.collapsed_to_chrome(merged, hz=25.0)
    xs = [e for e in events if e.get("ph") == "X"]
    assert len(xs) == 3
    heavy = [e for e in xs if e["args"]["samples"] == 5]
    assert len(heavy) == 1
    assert heavy[0]["args"]["stack"] == "f1;f2"
    assert heavy[0]["dur"] == pytest.approx(5 * 1e6 / 25.0)
    # node split into pids, procs into tids, named by metadata
    metas = [e for e in events if e.get("ph") == "M"]
    assert {m["args"]["name"] for m in metas
            if m["name"] == "process_name"} == {"node:n1", "node:n2"}


def test_capture_to_file_noop_when_unarmed(tmp_path):
    before = set(threading.enumerate())
    with profiler.capture_to_file(None) as s:
        assert s is None
        assert set(threading.enumerate()) == before  # nothing spawned
    path = str(tmp_path / "x.collapsed")
    with profiler.capture_to_file(path, hz=100):
        time.sleep(0.1)
    with open(path) as f:
        assert f.read()  # something was written


def _seeded_stacks(rng, n):
    frames = [f"f{i}.py:fn{i}" for i in range(12)]
    out = {}
    for _ in range(n):
        depth = int(rng.randint(1, 6))
        key = ";".join(rng.choice(frames, depth))
        out[key] = out.get(key, 0) + int(rng.randint(1, 50))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collapsed_helpers_match_jax(seed):
    from ray_tpu.util import profiler as jprof

    rng = np.random.RandomState(seed)
    pages = [(_seeded_stacks(rng, 30), f"node:n{i % 2};proc:w{i}")
             for i in range(4)]
    got = profiler.merge_collapsed(
        [profiler.prefix_stacks(p, pre) for p, pre in pages])
    want = jprof.merge_collapsed(
        [jprof.prefix_stacks(p, pre) for p, pre in pages])
    assert got == want
    assert profiler.collapsed_text(got) == jprof.collapsed_text(want)
    assert profiler.collapsed_to_chrome(got, 25.0) == \
        jprof.collapsed_to_chrome(want, 25.0)


# ---------------------------------------------------------------------------
# watchtower: the stranded-refs rule
# ---------------------------------------------------------------------------

def test_stranded_watchtower_rule_fires_on_synthetic_leak():
    from ray_tpu_torch.util.watchtower import Watchtower, default_rules

    rules = {r.name: r for r in default_rules()}
    rule = rules["object-stranded-refs"]
    assert rule.metric == "object_store_stranded_bytes"
    cur = {"v": 0.0}
    wt = Watchtower(
        lambda: f'object_store_stranded_bytes{{proc="w1"}} {cur["v"]}\n',
        period_s=0, rules=[rule])
    # healthy: below threshold, no alert
    for i in range(5):
        wt.sample_once(now=float(i * 10))
    assert wt.alerts_dict()["alerts"] == []
    # synthetic leak: stranded bytes jump past the threshold and hold
    cur["v"] = rule.threshold * 2
    t = 50.0
    fired = False
    while t < 50.0 + rule.window_s + rule.for_s + 30:
        wt.sample_once(now=t)
        states = [a["state"] for a in wt.alerts_dict()["alerts"]]
        if "firing" in states:
            fired = True
            break
        t += 10.0
    assert fired, wt.alerts_dict()
    # leak fixed: the alert resolves
    cur["v"] = 0.0
    wt.sample_once(now=t + 10)
    assert wt.alerts_dict()["alerts"] == []


# ---------------------------------------------------------------------------
# live 2-node cluster: profile e2e, cpu attribution, auditor, dump
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster2():
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "resources": {"p5a": 2.0}})
    c.add_node(num_cpus=4, resources={"p5b": 2.0})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()


@ray_tpu.remote(num_cpus=0.1)
def _p5_busy(seconds):
    t0 = time.monotonic()
    x = 0
    while time.monotonic() - t0 < seconds:
        x += sum(range(128))
    return x


def test_profile_e2e_two_nodes(cluster2):
    """THE live gate: `profile` returns merged node/proc-tagged stacks
    from both nodes of a 2-node cluster, with worker code visible."""
    from ray_tpu_torch.util import state

    refs = ([_p5_busy.options(resources={"p5a": 0.5}).remote(3.0)
             for _ in range(2)] +
            [_p5_busy.options(resources={"p5b": 0.5}).remote(3.0)
             for _ in range(2)])
    time.sleep(0.5)  # workers spinning before the window opens
    r = state.profile(duration_s=1.0)
    ray_tpu.get(refs, timeout=120)
    assert r["errors"] == {}
    assert r["samples"] > 0
    node_tags = {k.split(";", 1)[0] for k in r["stacks"]
                 if k.startswith("node:")}
    expected = {f"node:{nl.node_id.hex()[:12]}"
                for nl in cluster2.nodelets}
    assert expected <= node_tags, (expected, node_tags)
    # the head and this driver sampled themselves too
    assert "node:head" in node_tags and "node:driver" in node_tags
    # worker procs are tagged, and the busy task's frames are visible
    busy = [k for k in r["stacks"] if ":_p5_busy" in k]
    assert busy and all(";proc:" in k for k in busy)
    busy_nodes = {k.split(";", 1)[0] for k in busy}
    assert len(busy_nodes) == 2, f"busy stacks from one node only: {busy_nodes}"
    # collapsed text + chrome conversion round-trip on real output
    text = profiler.collapsed_text(r["stacks"])
    assert text.splitlines()[0].rsplit(" ", 1)[1].isdigit()
    events = profiler.collapsed_to_chrome(r["stacks"], r["hz"])
    assert any(e.get("ph") == "X" for e in events)


def test_profile_cli_writes_collapsed(cluster2, tmp_path):
    from ray_tpu_torch.scripts.cli import main as cli_main

    out = str(tmp_path / "p.collapsed")
    chrome = str(tmp_path / "p.json")
    rc = cli_main(["profile", "--address", cluster2.address,
                   "-d", "0.5", "-o", out, "--chrome", chrome])
    assert rc == 0
    with open(out) as f:
        content = f.read()
    assert "node:" in content and ";proc:" in content
    import json

    with open(chrome) as f:
        assert isinstance(json.load(f), list)


def test_cpu_attribution_cluster_wide(cluster2):
    from ray_tpu_torch.util import state

    @ray_tpu.remote(num_cpus=0.1)
    class P5Actor:
        def burn(self, seconds):
            t0 = time.thread_time()
            x = 0
            while time.thread_time() - t0 < seconds:
                x += sum(range(128))
            return x

    ray_tpu.get([_p5_busy.remote(0.4) for _ in range(3)], timeout=120)
    a = P5Actor.remote()
    ray_tpu.get([a.burn.remote(0.3) for _ in range(2)], timeout=120)
    cpu = state.cpu_attribution()
    rows = {(r["label"], r["kind"]): r for r in cpu["rows"]}
    task_row = rows.get(("_p5_busy", "task"))
    assert task_row is not None, cpu["rows"]
    assert task_row["calls"] >= 3
    assert task_row["cpu_seconds"] > 0.5  # 3 x ~0.4s of pure spin
    actor_row = rows.get(("P5Actor.burn", "actor"))
    assert actor_row is not None, cpu["rows"]
    assert actor_row["calls"] >= 2 and actor_row["cpu_seconds"] > 0.3
    assert cpu["total_cpu_seconds"] >= task_row["cpu_seconds"]
    # the counter face reaches the cluster metrics page via the scrape
    # (the aggregation injects node=/proc= tags after the kind tag)
    text = state.cluster_metrics()
    assert 'core_task_cpu_seconds_total{kind="actor"' in text
    assert 'core_task_cpu_seconds_total{kind="task"' in text
    assert "object_store_stranded_bytes" in text


def test_stranded_auditor_flags_synthetic_leak(cluster2):
    from ray_tpu_torch.core import api as _api

    rt = _api._runtime
    ref = ray_tpu.put(b"p5-leak" * 512)
    oid = ref.id.binary().hex()
    time.sleep(0.15)
    stranded = {o["object_id"]: o for o in rt.audit_stranded(0.1)}
    assert oid in stranded
    assert stranded[oid]["label"] == "put"
    assert stranded[oid]["size"] >= 7 * 512
    # consumer progress clears the flag
    ray_tpu.get(ref)
    assert oid not in {o["object_id"] for o in rt.audit_stranded(0.0)}
    # task returns: stranded until consumed, clean after
    r2 = _p5_busy.remote(0.01)
    ray_tpu.wait([r2], timeout=60)
    time.sleep(0.1)
    oid2 = r2.id.binary().hex()
    audit = {o["object_id"]: o for o in rt.audit_stranded(0.05)}
    assert oid2 in audit and audit[oid2]["label"] == "_p5_busy"
    ray_tpu.get(r2, timeout=60)
    assert oid2 not in {o["object_id"] for o in rt.audit_stranded(0.0)}


def test_errored_ref_regression_stays_clean(cluster2):
    """The traceback-pin shape: a fetched error must not strand
    its oid — the ref frees from _owned on release, and the auditor
    never carries it forward."""
    from ray_tpu_torch.core import api as _api

    rt = _api._runtime

    @ray_tpu.remote(num_cpus=0.1)
    def p5_boom():
        raise ValueError("p5 kaboom")

    ref = p5_boom.remote()
    with pytest.raises(Exception, match="p5 kaboom"):
        ray_tpu.get(ref, timeout=60)
    b = ref.id.binary()
    oid = b.hex()
    # consumed at the raising get: not stranded even at threshold 0
    assert oid not in {o["object_id"] for o in rt.audit_stranded(0.0)}
    del ref
    gc.collect()
    assert b not in rt._owned  # freed, not pinned by its own traceback


def test_memory_summary_attribution_and_report(cluster2):
    from ray_tpu_torch.util import state

    keep = ray_tpu.put(b"p5-mem" * 1024)  # held, unconsumed
    time.sleep(0.15)
    s = state.memory_summary(stranded_age_s=0.1)
    assert "put" in s["by_label"]
    put_agg = s["by_label"]["put"]
    assert put_agg["count"] >= 1 and put_agg["bytes"] >= 6 * 1024
    assert put_agg["stranded_count"] >= 1
    assert sum(put_agg["ages"].values()) == put_agg["count"]
    assert s["stranded"]["count"] >= 1
    assert any(o["label"] == "put" for o in s["stranded"]["top"])
    rep = state.memory_report(stranded_age_s=0.1)
    for section in ("=== by owner ===", "=== by creator ===",
                    "stranded refs"):
        assert section in rep, rep
    ray_tpu.get(keep)


def test_debug_dump_includes_profile_and_attribution(cluster2, tmp_path):
    from ray_tpu_torch.util import state

    ray_tpu.get(_p5_busy.remote(0.2), timeout=120)
    out = state.debug_dump(out_dir=str(tmp_path / "dump"), deadline_s=45)
    files = set(os.listdir(out))
    assert "profile.collapsed" in files, files
    import json

    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert "profile" in summary["artifacts"], summary
    with open(os.path.join(out, "profile.collapsed")) as f:
        collapsed = f.read()
    assert "node:" in collapsed
    with open(os.path.join(out, "memory.txt")) as f:
        mem = f.read()
    assert "=== by creator ===" in mem and "stranded refs" in mem
