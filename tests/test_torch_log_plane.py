"""Log plane: structured JSONL records with trace/task attribution,
worker stdout capture + driver mirroring (RAY_TPU_LOG_TO_DRIVER), the
nodelet/head `log_query`/`cluster_logs` query path, the CLI's `logs`,
the watchtower error-rate rule with attached log context, and the
debug-dump incident-logs artifact — the scenarios of
tests/test_log_plane.py (18) on the port, with its two-node cluster;
and the sink's records and `query_log_dir`'s answers held against the
JAX package's on the same seeded records.

One change to a scenario: the capture's 1 % overhead gate paces its
prints by the printing thread's CPU time, where JAX paces them by the
wall clock, so a loaded machine (fewer CPU seconds in the same wall
window, as many prints) cannot fail it; the bar is JAX's."""

import io
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.utils import logging as slog


# ---------------------------------------------------------------------------
# units: sink, handler, capture, query (no cluster)
# ---------------------------------------------------------------------------

def test_sink_rotation_stays_under_budget(tmp_path):
    path = str(tmp_path / "unit.jsonl")
    budget = 64 * 1024
    sink = slog.LogSink(path, max_bytes=budget)
    for i in range(4000):
        sink.write({"ts": float(i), "level": "info",
                    "msg": "x" * 64, "i": i})
    assert sink.written == 4000 and sink.dropped == 0
    total = sum(os.path.getsize(os.path.join(tmp_path, f))
                for f in os.listdir(tmp_path))
    assert total <= budget + 4096, total  # two-file rotation bound
    assert os.path.exists(path + ".1")  # the rotated half exists
    # the current file still parses, newest records last
    with open(path) as f:
        last = json.loads(f.readlines()[-1])
    assert last["i"] == 3999


def test_handler_emits_schema_records(tmp_path):
    path = str(tmp_path / "h.jsonl")
    handler = slog.StructuredLogHandler(
        slog.LogSink(path), node="n1", proc="p1", role="worker")
    logger = logging.getLogger("logplane.unit")
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    try:
        logger.error("boom %d", 7)
        logger.info("fine")
    finally:
        logger.removeHandler(handler)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2
    err = recs[0]
    assert err["level"] == "error" and err["msg"] == "boom 7"
    assert err["logger"] == "logplane.unit" and err["source"] == "log"
    assert err["node"] == "n1" and err["proc"] == "p1"
    assert err["role"] == "worker" and err["pid"] == os.getpid()
    # epoch-anchored ts: comparable with wall clock
    assert abs(err["ts"] - time.time()) < 60.0
    assert recs[1]["level"] == "info"


def test_stream_capture_lines_levels_and_mirror(tmp_path):
    sink = slog.LogSink(str(tmp_path / "cap.jsonl"))
    inner = io.StringIO()
    mirrored = []
    cap = slog.StdStreamCapture(
        inner, "stderr", sink, {"node": "n", "proc": "p",
                                "role": "worker", "pid": 1},
        mirror_fn=lambda line, src: mirrored.append((line, src)))
    print("first line", file=cap)
    cap.write("partial ")
    cap.write("then complete\nand more\n")
    # passthrough preserved byte-for-byte
    assert inner.getvalue() == ("first line\npartial then complete\n"
                                "and more\n")
    with open(str(tmp_path / "cap.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["msg"] for r in recs] == ["first line",
                                       "partial then complete",
                                       "and more"]
    assert all(r["source"] == "stderr" and r["level"] == "warning"
               for r in recs)
    assert [m[0] for m in mirrored] == [r["msg"] for r in recs]


def test_stream_capture_reentry_guard(tmp_path):
    sink = slog.LogSink(str(tmp_path / "re.jsonl"))
    inner = io.StringIO()
    cap = slog.StdStreamCapture(inner, "stdout", sink,
                                {"node": "n", "proc": "p",
                                 "role": "worker", "pid": 1})
    # a mirror that itself prints (a failing send logging its failure)
    # must pass through without recursing into a second emit
    cap.mirror_fn = lambda line, src: cap.write("side effect\n")
    print("real line", file=cap)
    with open(str(tmp_path / "re.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["msg"] for r in recs] == ["real line"]
    assert "side effect" in inner.getvalue()  # passthrough still ran


def test_stream_capture_armed_overhead_under_1pct(tmp_path):
    """The capture meters its own CPU; a busy loop that prints at a
    realistic cadence (one line every 20 ms of its own CPU time) must
    spend <1% of its thread time inside the structured-emit path."""
    sink = slog.LogSink(str(tmp_path / "ov.jsonl"))
    inner = io.StringIO()
    cap = slog.StdStreamCapture(inner, "stdout", sink,
                                {"node": "n", "proc": "p",
                                 "role": "worker", "pid": 1})
    window = 0.5
    x = 0
    n_prints = 0
    cpu0 = time.thread_time()
    next_print = cpu0
    deadline = time.monotonic() + 30.0
    while time.thread_time() - cpu0 < window \
            and time.monotonic() < deadline:
        x += sum(range(256))
        now = time.thread_time()
        if now >= next_print:
            print(f"progress {x}", file=cap)
            n_prints += 1
            next_print = now + 0.02
    busy_cpu = time.thread_time() - cpu0
    assert n_prints >= 5
    assert cap.cpu_seconds < 0.01 * busy_cpu, (
        f"capture burned {cap.cpu_seconds:.5f}s of a {busy_cpu:.3f}s "
        f"busy window across {n_prints} prints")


def _write_records(sink, base_ts):
    rows = [
        {"ts": base_ts + 1, "level": "info", "msg": "alpha starting",
         "logger": "app", "node": "nodeaa", "task": "t1",
         "trace_id": "traceX", "proc": "w1", "source": "log"},
        {"ts": base_ts + 2, "level": "error", "msg": "alpha failed",
         "logger": "app", "node": "nodeaa", "task": "t1",
         "trace_id": "traceX", "proc": "w1", "source": "log"},
        {"ts": base_ts + 3, "level": "warning", "msg": "beta slow",
         "logger": "other", "node": "nodeaa", "task": "t2",
         "trace_id": "traceY", "proc": "w2", "source": "stdout"},
    ]
    for r in rows:
        sink.write(r)
    return rows


def test_query_log_dir_filters_and_follow(tmp_path):
    d = str(tmp_path)
    sink = slog.LogSink(os.path.join(d, "worker-w1.jsonl"))
    base = time.time()
    _write_records(sink, base)
    # level is a minimum severity
    r = slog.query_log_dir(d, level="warning")
    assert [x["msg"] for x in r["records"]] == ["alpha failed",
                                               "beta slow"]
    # grep over msg, trace/task/proc exact, time window
    assert [x["msg"] for x in
            slog.query_log_dir(d, grep="alph")["records"]] == \
        ["alpha starting", "alpha failed"]
    assert all(x["task"] == "t1" for x in
               slog.query_log_dir(d, task="t1")["records"])
    assert [x["msg"] for x in
            slog.query_log_dir(d, trace_id="traceY")["records"]] == \
        ["beta slow"]
    assert [x["proc"] for x in
            slog.query_log_dir(d, proc="w2")["records"]] == ["w2"]
    assert [x["msg"] for x in
            slog.query_log_dir(d, since=base + 2.5)["records"]] == \
        ["beta slow"]
    # bounded reply: limit keeps the LAST records by ts + truncated flag
    r = slog.query_log_dir(d, limit=1)
    assert r["truncated"] and [x["msg"] for x in r["records"]] == \
        ["beta slow"]
    # node filter drops foreign-origin records (shared-dir clusters)
    assert slog.query_log_dir(d, node="nodebb")["records"] == []
    # follow: offsets make the next query incremental
    r = slog.query_log_dir(d)
    assert len(r["records"]) == 3
    sink.write({"ts": base + 9, "level": "info", "msg": "new one",
                "node": "nodeaa", "source": "log"})
    r2 = slog.query_log_dir(d, offsets=r["offsets"])
    assert [x["msg"] for x in r2["records"]] == ["new one"]
    # nothing new -> empty, offsets stable
    r3 = slog.query_log_dir(d, offsets=r2["offsets"])
    assert r3["records"] == [] and r3["offsets"] == r2["offsets"]


def test_stream_capture_concurrent_threads_lose_nothing(tmp_path):
    """Line assembly is per-thread: N exec threads printing through
    the ONE worker capture interleave at line granularity — every line
    lands exactly once (a shared buffer would drop or merge
    concurrently-appended partials)."""
    sink = slog.LogSink(str(tmp_path / "mt.jsonl"))
    cap = slog.StdStreamCapture(io.StringIO(), "stdout", sink,
                                {"node": "n", "proc": "p",
                                 "role": "worker", "pid": 1})

    def chatter(tid):
        for i in range(200):
            # two writes per line forces a cross-call partial buffer
            cap.write(f"thread{tid} ")
            cap.write(f"line{i}\n")

    threads = [threading.Thread(target=chatter, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(str(tmp_path / "mt.jsonl")) as f:
        msgs = [json.loads(line)["msg"] for line in f]
    assert sorted(msgs) == sorted(
        f"thread{t} line{i}" for t in range(4) for i in range(200))


def test_query_follow_survives_rotation_without_duplicates(tmp_path):
    """A rotation between two follow polls carries the cursor over to
    the `.1` half: the follower sees every record exactly once."""
    d = str(tmp_path)
    sink = slog.LogSink(os.path.join(d, "worker-w1.jsonl"),
                        max_bytes=8 * 1024)
    seen: list[int] = []
    offsets = None
    i = 0
    for _ in range(6):
        for _ in range(20):  # ~100B/record: rotation every ~2 rounds
            sink.write({"ts": float(i), "level": "info", "i": i,
                        "msg": f"record {i:04d} " + "x" * 64,
                        "node": "nodeaa", "source": "log"})
            i += 1
        r = slog.query_log_dir(d, offsets=offsets, limit=5000)
        seen.extend(rec["i"] for rec in r["records"])
        offsets = r["offsets"]
    assert os.path.exists(os.path.join(d, "worker-w1.jsonl.1"))
    assert seen == list(range(i)), (len(seen), i)


def test_query_follow_rotation_gap_no_current_file(tmp_path):
    """A poll landing in the rotation gap (current file replaced, next
    write not yet landed) still carries the cursor to the `.1` half —
    no re-delivery of the rotated-out records."""
    d = str(tmp_path)
    path = os.path.join(d, "worker-w1.jsonl")
    sink = slog.LogSink(path, max_bytes=1 << 20)
    for i in range(10):
        sink.write({"ts": float(i), "level": "info", "i": i,
                    "msg": f"r{i}", "node": "nodeaa", "source": "log"})
    r = slog.query_log_dir(d)
    assert len(r["records"]) == 10
    # rotation between polls; nothing has recreated the current file
    sink._close_fh_locked()
    os.replace(path, path + ".1")
    r2 = slog.query_log_dir(d, offsets=r["offsets"])
    assert r2["records"] == [], [x["i"] for x in r2["records"]]
    # the next write recreates the current file; only IT is new
    sink.write({"ts": 99.0, "level": "info", "i": 99, "msg": "new",
                "node": "nodeaa", "source": "log"})
    r3 = slog.query_log_dir(d, offsets=r2["offsets"])
    assert [x["i"] for x in r3["records"]] == [99]


def test_query_follow_rotation_outgrown_current_file(tmp_path):
    """Rotation is detected by inode IDENTITY, not size: if the
    recreated current file grows past the stale cursor before the next
    poll (an error burst — exactly when someone is tailing), the
    cursor still carries to the `.1` half and nothing is skipped or
    re-shown."""
    d = str(tmp_path)
    path = os.path.join(d, "worker-w1.jsonl")
    sink = slog.LogSink(path, max_bytes=1 << 20)

    def w(i, pad=16):
        sink.write({"ts": float(i), "level": "info", "i": i,
                    "msg": "m" * pad, "node": "nodeaa",
                    "source": "log"})

    for i in range(5):
        w(i)
    r = slog.query_log_dir(d)
    assert len(r["records"]) == 5
    for i in range(5, 8):
        w(i)  # unread tail about to rotate away
    sink._close_fh_locked()
    os.replace(path, path + ".1")
    sink._cur_bytes = 0
    for i in range(8, 28):
        w(i, pad=64)  # burst: the new file outgrows the stale cursor
    assert os.path.getsize(path) > r["offsets"]["worker-w1.jsonl"][1]
    r2 = slog.query_log_dir(d, offsets=r["offsets"])
    assert [x["i"] for x in r2["records"]] == list(range(5, 28))


def _seeded_records(seed, n=300):
    rng = np.random.RandomState(seed)
    levels = ["debug", "info", "warning", "error"]
    out = []
    for i in range(n):
        out.append({"ts": 1000.0 + i * 0.5 + float(rng.rand()),
                    "level": levels[int(rng.randint(4))],
                    "msg": f"m{i} " + "x" * int(rng.randint(0, 90)),
                    "logger": f"lg{int(rng.randint(3))}",
                    "node": ("nodeaa", "nodebb")[int(rng.randint(2))],
                    "task": f"t{int(rng.randint(5))}",
                    "trace_id": f"tr{int(rng.randint(4))}",
                    "proc": f"w{int(rng.randint(3))}",
                    "source": ("log", "stdout", "stderr")[
                        int(rng.randint(3))], "i": i})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_sink_and_query_match_jax(tmp_path, seed):
    """The same seeded records through both packages' sinks (a budget
    small enough to rotate) give the same files, and `query_log_dir`
    gives the same answers over them for each filter."""
    from ray_tpu.utils import logging as jlog

    recs = _seeded_records(seed)
    dirs = {}
    for name, mod in (("jax", jlog), ("port", slog)):
        d = tmp_path / name
        d.mkdir()
        sink = mod.LogSink(str(d / "worker-w1.jsonl"), max_bytes=16 * 1024)
        for r in recs:
            sink.write(dict(r))
        assert sink.written == len(recs)
        dirs[name] = str(d)
    for fn in sorted(os.listdir(dirs["jax"])):
        with open(os.path.join(dirs["jax"], fn)) as a, \
                open(os.path.join(dirs["port"], fn)) as b:
            assert a.read() == b.read(), fn
    assert sorted(os.listdir(dirs["port"])) == sorted(
        os.listdir(dirs["jax"]))
    queries = [{}, {"level": "warning"}, {"grep": "m1[0-9]+ "},
               {"task": "t2"}, {"trace_id": "tr1", "limit": 7},
               {"since": 1080.0, "until": 1120.0}, {"proc": "w0"},
               {"node": "nodebb"}]
    for q in queries:
        got = slog.query_log_dir(dirs["port"], **q)
        want = jlog.query_log_dir(dirs["jax"], **q)
        assert got["records"] == want["records"], q
        assert got["truncated"] == want["truncated"], q


# ---------------------------------------------------------------------------
# watchtower: the error-rate-spike rule + context attachment (synthetic)
# ---------------------------------------------------------------------------

def test_log_error_spike_rule_fires_with_context_and_resolves():
    from ray_tpu_torch.util.watchtower import Watchtower, default_rules

    rules = {r.name: r for r in default_rules()}
    rule = rules["log-error-spike"]
    assert rule.metric == "log_records_total"
    assert rule.labels == {"level": "error"}
    cur = {"v": 0.0}
    ctx_calls = []

    def scrape():
        return (f'log_records_total{{level="error",proc="w1"}} '
                f'{cur["v"]}\n')

    def log_ctx(n):
        ctx_calls.append(n)
        return [{"level": "error", "msg": f"ctx line {i}"}
                for i in range(n + 7)]

    wt = Watchtower(scrape, period_s=0, rules=[rule],
                    log_context_fn=log_ctx)
    t = 1000.0
    for _ in range(4):
        wt.sample_once(now=t)
        t += 5.0
    assert wt.alerts_dict()["alerts"] == []
    fired = None
    for _ in range(20):  # burst: ~12 errors/s sustained
        cur["v"] += 60.0
        wt.sample_once(now=t)
        t += 5.0
        firing = [a for a in wt.alerts_dict()["alerts"]
                  if a["state"] == "firing"]
        if firing:
            fired = firing[0]
            break
    assert fired is not None, wt.alerts_dict()
    assert fired["rule"] == "log-error-spike"
    # the firing transition fetched and attached BOUNDED log context
    assert ctx_calls == [20]
    assert len(fired["context"]) == 20
    assert fired["context"][0]["level"] == "error"
    # burst over: the windowed rate decays and the alert resolves
    for _ in range(20):
        wt.sample_once(now=t)
        t += 5.0
        if not wt.alerts_dict()["alerts"]:
            break
    assert wt.alerts_dict()["alerts"] == []


# ---------------------------------------------------------------------------
# CLI follow: terminates cleanly when the head goes away
# ---------------------------------------------------------------------------

def test_follow_terminates_cleanly_on_head_shutdown():
    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.scripts.cli import main as cli_main

    head = Head(watchtower_period_s=0).start()
    rc = {}

    def run():
        rc["v"] = cli_main(["logs", "--address", head.address,
                            "--follow", "--poll", "0.2",
                            "--rpc-timeout", "2", "--tail", "5"])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(1.0)  # at least one poll round against the live head
    assert t.is_alive()
    head.stop()
    # the follow rides out up to 3 consecutive missed polls (a busy
    # head mid-incident must not kill the tail) at ~(rpc_timeout+5)s
    # each before concluding the head is gone
    t.join(timeout=45)
    assert not t.is_alive(), "--follow hung after head shutdown"
    assert rc.get("v") == 0, rc


# ---------------------------------------------------------------------------
# live 2-node cluster: THE correlation gate + CLI + dump + degraded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster2():
    from ray_tpu_torch.cluster_utils import Cluster

    os.environ["RAY_TPU_LOG_TO_DRIVER"] = "1"
    # the error-burst test drives the head watchtower's sample_once
    # manually with deterministic timestamps; its wall-clock loop must
    # not interleave real-now samples into the same history
    os.environ["RAY_TPU_WATCHTOWER"] = "0"
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "resources": {"lpa": 2.0}})
    c.add_node(num_cpus=4, resources={"lpb": 2.0})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    ray_tpu.shutdown()
    c.shutdown()
    os.environ.pop("RAY_TPU_LOG_TO_DRIVER", None)
    os.environ.pop("RAY_TPU_WATCHTOWER", None)


@ray_tpu.remote(num_cpus=0.1)
def lp_task():
    print("hello from lp_task stdout")
    logging.getLogger("lp.app").error("lp synthetic failure")
    return ray_tpu.get_runtime_context().get_task_id()


@ray_tpu.remote(num_cpus=0.1)
def lp_error_burst(n):
    log = logging.getLogger("lp.burst")
    for i in range(n):
        log.error("burst error %d", i)
    return n


def _query(retries=20, **kw):
    """cluster_logs with a short settle loop (worker sink writes are
    synchronous, but the records must exist before the query)."""
    from ray_tpu_torch.util import state

    for _ in range(retries):
        r = state.cluster_logs(**kw)
        if r["records"]:
            return r
        time.sleep(0.25)
    return r


def test_log_correlation_e2e(cluster2):
    """THE acceptance gate: a task that both print()s and logs an
    error has BOTH lines retrievable by task id and by trace id,
    tagged with the same trace_id as the task's span on the merged
    timeline; the driver mirror carries the (task, node) prefix."""
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.util import state, tracing

    with tracing.span("lp-e2e") as tr:
        task_id = ray_tpu.get(
            lp_task.options(resources={"lpa": 0.5}).remote(),
            timeout=60)
    trace_id = tr["trace_id"]

    r = _query(task=task_id)
    by_source = {rec["source"]: rec for rec in r["records"]}
    assert set(by_source) == {"stdout", "log"}, r["records"]
    assert by_source["stdout"]["msg"] == "hello from lp_task stdout"
    assert by_source["log"]["msg"] == "lp synthetic failure"
    assert by_source["log"]["level"] == "error"
    assert by_source["log"]["logger"] == "lp.app"
    # both lines carry the submitting span's trace context
    assert all(rec["trace_id"] == trace_id for rec in r["records"])
    assert all(rec["task"] == task_id for rec in r["records"])
    assert all(rec.get("task_name") == "lp_task"
               for rec in r["records"])

    # the same two lines come back by trace id
    r2 = _query(trace_id=trace_id)
    assert {rec["source"] for rec in r2["records"]} == {"stdout", "log"}

    # ...and the trace_id matches the task's span on the merged
    # timeline (worker span flush is ~1s periodic)
    span = None
    for _ in range(30):
        tl = state.cluster_timeline()
        spans = [e for e in tl if e.get("ph") == "X"
                 and e.get("name") == "lp_task"
                 and e.get("args", {}).get("trace_id") == trace_id]
        if spans:
            span = spans[0]
            break
        time.sleep(0.5)
    assert span is not None, "task span with the log lines' trace_id"

    # driver mirroring: the print arrived with (task, node) identity
    rt = _api._runtime
    mirrored = [m for m in rt._mirrored_logs
                if m.get("task_id") == task_id]
    assert mirrored, list(rt._mirrored_logs)
    assert mirrored[0]["task"] == "lp_task"
    assert mirrored[0]["line"] == "hello from lp_task stdout"
    assert mirrored[0]["node"]  # node identity rides the mirror
    assert mirrored[0]["pid"]

    # the log counters reached the cluster metrics page
    text = state.cluster_metrics()
    assert 'log_records_total{level="error"' in text
    assert "log_bytes_total" in text


def test_logs_cli_task_and_trace_filters(cluster2, capsys):
    from ray_tpu_torch.scripts.cli import main as cli_main
    from ray_tpu_torch.util import tracing

    with tracing.span("lp-cli") as tr:
        task_id = ray_tpu.get(
            lp_task.options(resources={"lpb": 0.5}).remote(),
            timeout=60)
    _query(task=task_id)  # settle
    rc = cli_main(["logs", "--address", cluster2.address,
                   "--task", task_id])
    assert rc == 0
    out = capsys.readouterr().out
    assert "hello from lp_task stdout" in out
    assert "lp synthetic failure" in out
    assert "[lp_task]" in out  # the formatted line names the task
    rc = cli_main(["logs", "--address", cluster2.address,
                   "--trace-id", tr["trace_id"], "--json"])
    assert rc == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.splitlines() if ln.strip()]
    assert {rec["source"] for rec in lines} >= {"stdout", "log"}
    # legacy raw-file mode still lists a node's files
    nid = cluster2.nodelets[0].node_id.hex()[:12]
    rc = cli_main(["logs", nid, "--address", cluster2.address])
    assert rc == 0
    assert json.loads(capsys.readouterr().out), "raw file listing"


def test_error_burst_fires_live_watchtower_with_context(cluster2):
    """Synthetic error burst on the LIVE cluster: real scrape, real
    log-context fan-out; sample ticks driven with deterministic
    timestamps (the watchtower loop is disabled in this fixture)."""
    wt = cluster2.head.watchtower
    t = 50_000.0
    for _ in range(3):
        wt.sample_once(now=t)
        t += 5.0
    fired = None
    for _ in range(12):
        ray_tpu.get(lp_error_burst.options(
            resources={"lpa": 0.2}).remote(40), timeout=60)
        wt.sample_once(now=t)
        t += 5.0
        firing = [a for a in wt.alerts_dict()["alerts"]
                  if a["rule"] == "log-error-spike"
                  and a["state"] == "firing"]
        if firing:
            fired = firing[0]
            break
    assert fired is not None, wt.alerts_dict()
    # the attached context is real error lines from the cluster
    assert fired.get("context"), fired
    assert any("burst error" in rec.get("msg", "")
               for rec in fired["context"])
    # burst over: the rate window drains and the alert resolves
    resolved = False
    for _ in range(20):
        wt.sample_once(now=t)
        t += 5.0
        if not [a for a in wt.alerts_dict()["alerts"]
                if a["rule"] == "log-error-spike"]:
            resolved = True
            break
    assert resolved, wt.alerts_dict()


def test_debug_dump_includes_incident_logs(cluster2, tmp_path):
    from ray_tpu_torch.util import state

    ray_tpu.get(lp_task.remote(), timeout=60)
    out = state.debug_dump(out_dir=str(tmp_path / "dump"),
                           deadline_s=45)
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert "cluster_logs" in summary["artifacts"], summary
    with open(os.path.join(out, "logs.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    assert recs, "incident-window structured logs captured"
    assert any(rec["level"] == "error" for rec in recs)
    # the raw per-node tails are still there alongside
    assert os.path.isdir(os.path.join(out, "logs"))


def test_cluster_logs_rpc_defaults_omitted_limit(cluster2):
    """The head RPC is public: a caller omitting "limit" (or sending
    None) gets the documented 1000-record default, not a per-node
    TypeError dressed up as every node timing out."""
    from ray_tpu_torch.core import api as _api

    rt = _api._runtime
    r = rt.client.call(rt.head_address, "cluster_logs", {}, timeout=15)
    assert r["records"], r
    assert not r["errors"], r["errors"]
    r2 = rt.client.call(rt.head_address, "cluster_logs",
                        {"limit": None}, timeout=15)
    assert r2["records"] and not r2["errors"], r2["errors"]


def test_degraded_cluster_log_query_lands_in_errors(cluster2):
    """LAST test in the module: it stops a node. The stopped node
    costs only the shared per-query budget and lands in `errors`;
    the gather still returns the surviving node's records."""
    from ray_tpu_torch.util import state

    victim = cluster2.nodelets[-1]
    vid = victim.node_id.hex()[:12]
    cluster2.remove_node(victim)
    t0 = time.monotonic()
    r = state.cluster_logs(timeout=4, limit=100)
    elapsed = time.monotonic() - t0
    assert elapsed < 15.0, elapsed
    assert r["records"], "surviving node still answers"
    assert all(rec.get("node") != vid for rec in r["records"])
    # immediately after the stop the head still lists the node alive,
    # so it must appear as an errors entry; once aged out of the view
    # it is excluded entirely — both are correct degraded shapes
    assert vid in r["errors"] or vid not in r["offsets"], r["errors"]
