"""Cluster CLI: the port's copy of ``ray_tpu/scripts/cli.py``.

Reference parity: python/ray/scripts/scripts.py — `ray start --head`,
`ray start --address`, `ray stop`, `ray status`, `ray list`, `ray up`,
`ray down`, `ray exec`, `ray attach`, `ray job submit`. No console
script is installed: run it as ``python -m ray_tpu_torch.scripts.cli``.
Usage:

  python -m ray_tpu_torch.scripts.cli start --head [--node-ip IP] \
      [--num-cpus N] [--num-gpus N] [--resources JSON] [--block]
  python -m ray_tpu_torch.scripts.cli start --address HOST:PORT [...]
  python -m ray_tpu_torch.scripts.cli stop   [--session-dir DIR]
  python -m ray_tpu_torch.scripts.cli up     CONFIG.yaml [--state-dir DIR]
  python -m ray_tpu_torch.scripts.cli down   CLUSTER [--state-dir DIR]
  python -m ray_tpu_torch.scripts.cli exec   [--state-dir DIR] CLUSTER -- CMD
  python -m ray_tpu_torch.scripts.cli attach CLUSTER [--state-dir DIR]
  python -m ray_tpu_torch.scripts.cli submit --address HOST:PORT
      [--submission-id ID] [--no-wait] -- CMD
  python -m ray_tpu_torch.scripts.cli job {list|status|logs|stop}
      --address HOST:PORT [--id ID]
  python -m ray_tpu_torch.scripts.cli status  --address HOST:PORT
  python -m ray_tpu_torch.scripts.cli summary --address HOST:PORT [--json]
  python -m ray_tpu_torch.scripts.cli explain TASK_ID --address HOST:PORT
  python -m ray_tpu_torch.scripts.cli critpath --address HOST:PORT
      [--trace-id T] [--json]
  python -m ray_tpu_torch.scripts.cli list {actors|nodes|pgs} --address ...
  python -m ray_tpu_torch.scripts.cli memory   --address HOST:PORT
  python -m ray_tpu_torch.scripts.cli timeline --address HOST:PORT -o out.json
  python -m ray_tpu_torch.scripts.cli metrics  --address HOST:PORT
  python -m ray_tpu_torch.scripts.cli alerts   --address HOST:PORT [--json]
  python -m ray_tpu_torch.scripts.cli profile  --address HOST:PORT [-d SECS]
  python -m ray_tpu_torch.scripts.cli logs     --address HOST:PORT [--follow]
      [--grep RE] [--level error] [--node N] [--task TID] [--trace-id T]
  python -m ray_tpu_torch.scripts.cli debug-dump --address HOST:PORT [-o DIR]

Deviations from the JAX CLI: `start` takes ``--num-gpus`` where JAX's
takes ``--num-tpus``; the default session root is the port's own,
``$TMPDIR/ray_tpu_torch`` (JAX's is ``/tmp/ray_tpu``), so a `stop`
without ``--session-dir`` signals the port's nodes only; and a node
started here shuts its nodelet and head down on SIGTERM (what `stop`
sends) as on ^C, so its store's segment is unlinked.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

_DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def _pidfile(session_dir: str) -> str:
    return os.path.join(session_dir, "cli_pids.json")


def _record_pid(session_dir: str, role: str):
    os.makedirs(session_dir, exist_ok=True)
    path = _pidfile(session_dir)
    pids = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                pids = json.load(f)
        except (OSError, ValueError):
            pids = []
    pids.append({"pid": os.getpid(), "role": role, "t": time.time()})
    with open(path, "w") as f:
        json.dump(pids, f)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def cmd_start(args):
    if args.node_ip:
        os.environ["RAY_TPU_NODE_IP"] = args.node_ip
    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.core.nodelet import Nodelet

    session_dir = args.session_dir or os.path.join(
        _DEFAULT_DIR, f"session_cli_{int(time.time())}")
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
    res = json.loads(args.resources) if args.resources else {}
    res.setdefault("CPU", float(args.num_cpus if args.num_cpus is not None
                                else os.cpu_count() or 1))
    if args.num_gpus:
        res["GPU"] = float(args.num_gpus)

    head = None
    if args.head:
        head = Head(session_name=os.path.basename(session_dir)).start()
        head_address = head.address
        print(f"head started at {head_address}")
        print(f"connect with: ray_tpu_torch.init(address={head_address!r})")
    else:
        if not args.address:
            print("error: start needs --head or --address", file=sys.stderr)
            return 2
        head_address = args.address
    nodelet = Nodelet(head_address, res,
                      labels=json.loads(args.labels or "{}"),
                      session_dir=session_dir).start()
    # this process (head+nodelet or nodelet) joins the structured log
    # plane too, so control-plane warnings are queryable via
    # `logs` like any worker's
    from ray_tpu_torch.utils import logging as slog

    slog.install_process_logging(
        role="head" if args.head else "nodelet",
        log_dir=nodelet.log_dir,
        node_id=nodelet.node_id.hex()[:12], proc="nodelet")
    print(f"nodelet started at {nodelet.address} with {res}", flush=True)
    if getattr(args, "node_info_file", None):
        # machine-readable handle for the cluster launcher / autoscaler
        # provider (reference: the node's metadata in the GCS node table)
        tmp = args.node_info_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"node_id_hex": nodelet.node_id.hex(),
                       "address": nodelet.address,
                       "head_address": head_address,
                       "pid": os.getpid()}, f)
        os.replace(tmp, args.node_info_file)
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(head_address)
        os.replace(tmp, args.address_file)
    _record_pid(session_dir, "head+nodelet" if args.head else "nodelet")
    # services are in-process threads: block until ^C or `stop`'s SIGTERM
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:  # graftlint: disable=except-hygiene
        pass  # ^C IS the stop signal: shutdown continues right below
    nodelet.stop()
    if head is not None:
        head.stop()
    return 0


def cmd_status(args):
    from ray_tpu_torch.util import state

    s = state.summarize(address=args.address)
    print(f"nodes: {s['nodes_alive']} alive, {s['nodes_dead']} dead")
    print(f"actors: {s['actors_alive']} alive / {s['actors_total']} total")
    print("resources:")
    for r, q in sorted(s["resources_total"].items()):
        a = s["resources_available"].get(r, 0.0)
        print(f"  {r}: {a:g}/{q:g} available")
    return 0


def cmd_summary(args):
    """One-screen cluster overview: nodes, actors by state, ledger
    task counts by lifecycle state, object bytes + stranded, firing
    alerts (reference: `ray summary`)."""
    from ray_tpu_torch.util import state

    s = state.cluster_summary(address=args.address)
    if args.json:
        print(json.dumps(s, indent=2, default=str))
        return 0
    c = s.get("cluster") or {}
    if c:
        print(f"nodes:  {c['nodes_alive']} alive, {c['nodes_dead']} dead")
        res = " ".join(
            f"{r}={c['resources_available'].get(r, 0.0):g}/{q:g}"
            for r, q in sorted(c["resources_total"].items()))
        print(f"resources (avail/total): {res}")
    ab = s.get("actors_by_state") or {}
    print("actors: " + (" ".join(f"{k}={v}" for k, v in sorted(ab.items()))
                        or "none"))
    t = s.get("tasks") or {}
    counts = t.get("counts") or {}
    print("tasks:  " + (" ".join(f"{k}={v}"
                                 for k, v in sorted(counts.items()))
                        or "none"))
    st = t.get("stats") or {}
    if st:
        print(f"ledger: {st.get('records', 0)}/{st.get('capacity', 0)} "
              f"records, {st.get('events_total', 0)} events, "
              f"{st.get('dropped_transitions_total', 0)} dropped, "
              f"{st.get('spilled_records_total', 0)} spilled")
    o = s.get("objects") or {}
    if o:
        print(f"objects: {o['objects_total']} "
              f"({o['objects_bytes'] / (1 << 20):.1f}MB), "
              f"stranded {o['stranded_count']} "
              f"({o['stranded_bytes'] / (1 << 20):.1f}MB)")
    al = s.get("alerts")
    if al:
        print(f"alerts: {len(al)} active")
        for a in al:
            print(f"  {a['rule']:<24} {a['severity']:<9} {a['state']}")
    elif al is not None:
        print("alerts: none")
    for name, err in sorted((s.get("errors") or {}).items()):
        print(f"  UNAVAILABLE {name}: {err}", file=sys.stderr)
    return 0


def cmd_explain(args):
    """Why is this task pending / why was it slow: the ledger
    transition waterfall plus the scheduler's placement verdict and
    each node's live feasibility view."""
    from ray_tpu_torch.util import state

    r = state.explain_task(args.task_id, address=args.address)
    if args.json:
        print(json.dumps(r, indent=2, default=str))
        return 0
    rec = r.get("record")
    if rec is None:
        print(f"task {args.task_id!r}: not in the ledger "
              "(never submitted here, or evicted beyond the spill)")
    else:
        print(f"task {rec['task_id'][:16]} {rec.get('name', '')!r} "
              f"state={rec['state']}")
        for tr in rec.get("transitions", ()):
            t = time.strftime("%H:%M:%S", time.localtime(tr["t"]))
            where = tr.get("node_id", "")[:12]
            detail = tr.get("detail", "")
            print(f"  {t} {tr['state']:<10} {where:<12} {detail}")
        wf = r.get("waterfall") or {}
        for ph in wf.get("phases", ()):
            print(f"  {ph['phase']:<24} {ph['ms']:>10.3f}ms")
        if wf.get("total_ms") is not None:
            print(f"  total {wf['total_ms']:.3f}ms  "
                  f"queue {wf.get('queue_ms', 0.0):.3f}ms  "
                  f"exec {wf.get('exec_ms', 0.0):.3f}ms")
    verdict = r.get("verdict") or (rec or {}).get("verdict")
    if verdict:
        print(f"verdict: {verdict.get('decision', '?')}"
              + (f" — {verdict['constraint']}"
                 if verdict.get("constraint") else ""))
        for n in verdict.get("nodes_considered", ()):
            print(f"  node {n['node_id']:<12} "
                  f"{'OK ' if n.get('ok') else 'NO '} {n.get('reason', '')}")
    for nid, info in sorted((r.get("nodes") or {}).items()):
        if not info.get("queued"):
            continue
        print(f"queued on {nid}: position {info.get('queue_position')} "
              f"of {info.get('queue_len')}, waited "
              f"{info.get('waited_s', 0.0)}s")
        if info.get("constraint"):
            print(f"  why pending: {info['constraint']}")
        for n in info.get("nodes_considered", ()):
            print(f"  node {n['node_id']:<12} "
                  f"{'OK ' if n.get('ok') else 'NO '} {n.get('reason', '')}")
    for nid, err in sorted((r.get("errors") or {}).items()):
        print(f"  MISSING node {nid}: {err}", file=sys.stderr)
    return 0


def cmd_critpath(args):
    """Critical path: with --trace-id, the blocking chain of one
    execution; without, the cross-execution aggregate (which work
    blocks, how often, for how much total time)."""
    from ray_tpu_torch.util import state

    r = state.critical_path(trace_id=args.trace_id, address=args.address)
    if args.json:
        print(json.dumps(r, indent=2, default=str))
        return 0
    if args.trace_id:
        print(f"trace {r['trace_id'][:16]}: e2e {r['e2e_ms']:.3f}ms, "
              f"path {r['path_ms']:.3f}ms "
              f"({r['coverage'] * 100:.1f}% coverage), "
              f"slowest: {r['slowest']}")
        for c in r["chain"]:
            print(f"  {c['name']:<32} {c['dur_ms']:>10.3f}ms "
                  f"slack={c['slack_ms']:>8.3f}ms "
                  f"node={c.get('node', '')[:12]}")
    else:
        print(f"{r['traces']} traces analyzed")
        print(f"{'NAME':<32} {'COUNT':>6} {'TOTAL':>12} {'MEAN':>10} "
              f"{'MAX':>10}  SHARE")
        for e in r["entries"][:args.limit]:
            print(f"{e['name']:<32} {e['count']:>6} "
                  f"{e['total_ms']:>10.3f}ms {e['mean_ms']:>8.3f}ms "
                  f"{e['max_ms']:>8.3f}ms  {e['share'] * 100:5.1f}%")
    return 0


def cmd_list(args):
    from ray_tpu_torch.util import state

    if args.kind == "actors":
        rows = state.list_actors(address=args.address)
    elif args.kind == "tasks":
        rows = state.list_tasks(address=args.address)
    elif args.kind == "nodes":
        rows = state.list_nodes(address=args.address)
    elif args.kind == "pgs":
        rows = state.list_placement_groups(address=args.address)
    elif args.kind == "objects":
        rows = state.list_objects(address=args.address)
    else:
        print(f"unknown kind {args.kind}", file=sys.stderr)
        return 2
    print(json.dumps(rows, indent=2, default=str))
    return 0


def cmd_memory(args):
    """Per-node store usage + per-owner object footprint (reference:
    `ray memory`)."""
    from ray_tpu_torch.util import state

    print(state.memory_report(address=args.address))
    return 0


def cmd_timeline(args):
    """Dump the merged cluster chrome trace (reference: `ray timeline`).
    Open the file at chrome://tracing or ui.perfetto.dev."""
    from ray_tpu_torch.util import state

    path = state.cluster_timeline(address=args.address,
                                  filename=args.output)
    print(f"wrote merged timeline to {path}")
    return 0


def cmd_metrics(args):
    """Print the cluster-wide Prometheus page (node/proc tags injected;
    the same text the head's /metrics HTTP endpoint serves)."""
    from ray_tpu_torch.util import state

    sys.stdout.write(state.cluster_metrics(address=args.address))
    return 0


def cmd_alerts(args):
    """Watchtower alerts: active pending/firing alerts plus the recent
    transition history (the same facts `util.state.alerts()` returns
    and `watchtower_alerts_firing{severity}` gauges on the metrics
    page)."""
    from ray_tpu_torch.util import state

    data = state.alerts(address=args.address)
    if args.json:
        print(json.dumps(data, indent=2, default=str))
        return 0
    active = sorted(data.get("alerts", ()),
                    key=lambda a: (a["state"], a["rule"]))
    if not active:
        print(f"no active alerts ({len(data.get('rules', ()))} rules "
              "watching)")
    else:
        print(f"{'RULE':<24} {'SEV':<9} {'STATE':<8} {'VALUE':>12} "
              f"{'THRESHOLD':>12}  SINCE")
        for a in active:
            since = time.strftime("%H:%M:%S",
                                  time.localtime(a["since"]))
            print(f"{a['rule']:<24} {a['severity']:<9} "
                  f"{a['state']:<8} {a['value']:>12.4g} "
                  f"{a['threshold']:>12.4g}  {since}")
    history = data.get("history", ())
    if history:
        print(f"--- last {min(len(history), args.limit)} transitions ---")
        for ev in list(history)[-args.limit:]:
            t = time.strftime("%H:%M:%S", time.localtime(ev["t"]))
            value = (f" value={ev['value']:.4g}"
                     if ev.get("value") is not None else "")
            print(f"  {t} {ev['rule']:<24} "
                  f"{ev['from'] or '-':<9}-> {ev['to']:<9}{value}")
    return 0


def cmd_profile(args):
    """Cluster-wide sampling profile: arm a capture window in every
    process (head, nodelets, workers, this CLI excluded) and write
    merged node/proc-tagged collapsed stacks — feed the .collapsed file
    to flamegraph.pl / speedscope, or --chrome for a chrome://tracing
    flame view."""
    from ray_tpu_torch.util import profiler, state

    r = state.profile(duration_s=args.duration, hz=args.hz,
                      address=args.address, include_driver=False)
    profiler.write_collapsed(args.output, r["stacks"])
    print(f"wrote {len(r['stacks'])} unique stacks to {args.output} "
          f"({r['samples']} samples @ {r['hz']:g}Hz across "
          f"{r['procs']} procs, {r['dropped']} dropped)")
    for nid, err in sorted(r.get("errors", {}).items()):
        print(f"  MISSING node {nid}: {err}", file=sys.stderr)
    if args.chrome:
        profiler.collapsed_to_chrome(r["stacks"], r["hz"],
                                     filename=args.chrome)
        print(f"wrote chrome flame view to {args.chrome}")
    return 0


def cmd_debug_dump(args):
    """Flight recorder: one post-mortem directory — state listings,
    memory report, serve/llm status, merged timeline, cluster metrics,
    per-node log tails. Deadline-bounded and best-effort, so it works
    against a degraded cluster too."""
    from ray_tpu_torch.util import state

    out = state.debug_dump(out_dir=args.output, address=args.address,
                           deadline_s=args.deadline)
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    ok, bad = summary.get("artifacts", {}), summary.get("errors", {})
    print(f"wrote debug dump to {out} "
          f"({len(ok)} artifacts, {len(bad)} failures, "
          f"{summary.get('elapsed_s', 0.0)}s)")
    for name, err in bad.items():
        print(f"  FAILED {name}: {err}", file=sys.stderr)
    return 0


def cmd_logs(args):
    """Cluster logs (reference: `ray logs` over the log monitor,
    _private/log_monitor.py:103 — here structured-first). Default mode
    queries the STRUCTURED log plane cluster-wide with
    grep/level/node/task/trace filters and supports `--follow`
    (incremental, offset-cursored). Legacy raw-file mode remains:
    `ray_tpu_torch.scripts.cli logs NODE [FILE] --address ...`
    lists/tails one node's raw log files byte-for-byte."""
    from ray_tpu_torch.util import state
    from ray_tpu_torch.utils.logging import format_record

    if args.node_or_file:
        # legacy raw-file mode
        if args.file is None:
            print(json.dumps(
                state.list_logs(args.node_or_file, address=args.address),
                indent=2))
            return 0
        text, _ = state.tail_log(args.node_or_file, args.file,
                                 nbytes=args.nbytes,
                                 address=args.address)
        sys.stdout.write(text)
        return 0

    def query(offsets=None, limit=None, window_s=None):
        return state.cluster_logs(
            address=args.address, level=args.level, grep=args.grep,
            node=args.node, task=args.task, trace_id=args.trace_id,
            proc=args.proc, limit=limit or args.tail,
            window_s=window_s, offsets=offsets,
            timeout=args.rpc_timeout)

    def show(reply, following=False):
        for rec in reply["records"]:
            print(json.dumps(rec, default=str) if args.json
                  else format_record(rec))
        if reply.get("truncated"):
            # never a silent gap: the reply cap dropped older records
            hint = ("burst exceeded the per-poll cap, older records "
                    "in the gap were skipped — narrow with "
                    "--grep/--level" if following else
                    "more matching records than the reply cap — "
                    "narrow with --grep/--level/--window or raise "
                    "--tail")
            print(f"  ... truncated: {hint}", file=sys.stderr)

    follow_since = time.monotonic()
    try:
        r = query(window_s=args.window)
    except ValueError as e:  # e.g. an invalid --grep regex
        print(f"logs: {e}", file=sys.stderr)
        return 2
    show(r)
    for nid, err in sorted(r.get("errors", {}).items()):
        print(f"  MISSING node {nid}: {err}", file=sys.stderr)
    if not args.follow:
        return 0
    # follow: pass each reply's offsets back so only NEW records ship.
    # A dead head ends the follow CLEANLY (note + exit 0): tailing a
    # cluster through its shutdown is the normal way this loop ends.
    offsets = dict(r.get("offsets") or {})
    drain = False
    misses = 0
    last_missing = set(r.get("errors") or {})
    try:
        while True:
            if not drain:
                time.sleep(args.poll)
            try:
                # per-poll limit pinned at the reply cap (a follow
                # wants everything new, not the one-shot's --tail
                # view) and time-bounded to the follow itself: a node
                # recovering mid-follow has no cursor yet, and its
                # fresh tail scan must not re-dump pre-follow history
                # into the stream
                r = query(offsets=offsets, limit=5000,
                          window_s=time.monotonic() - follow_since)
                misses = 0
            except Exception as e:  # noqa: BLE001
                # a busy head can miss one poll budget mid-incident —
                # exactly when someone is tailing; only consecutive
                # misses mean the head is actually gone
                misses += 1
                if misses < 3:
                    drain = False
                    continue
                print(f"log follow ended: head unreachable ({e})",
                      file=sys.stderr)
                return 0
            # merge PER FILE: a node that errored this round (absent
            # from the reply) keeps its cursors, and a file a nodelet
            # skipped on a transient read error keeps its cursor too —
            # replacing wholesale would rescan tails and re-print
            # already-shown records next poll
            for nid, cur in (r.get("offsets") or {}).items():
                merged = dict(offsets.get(nid) or {})
                merged.update(cur or {})
                offsets[nid] = merged
            show(r, following=True)
            # per-node errors surface on TRANSITION (noting a dead
            # node once beats repeating it every poll — and a quiet
            # tail must never mean "that node had nothing to say")
            missing = set(r.get("errors") or {})
            for nid in sorted(missing - last_missing):
                print(f"  MISSING node {nid}: {r['errors'][nid]}",
                      file=sys.stderr)
            for nid in sorted(last_missing - missing):
                print(f"  node {nid} answering again", file=sys.stderr)
            last_missing = missing
            # a truncated poll means a burst is in flight: poll again
            # immediately to drain instead of sleeping into more loss
            drain = bool(r.get("truncated"))
    except KeyboardInterrupt:  # graftlint: disable=except-hygiene
        return 0  # ^C IS how an operator ends a follow


def cmd_stop(args):
    session_dir = args.session_dir
    roots = ([session_dir] if session_dir else
             [os.path.join(_DEFAULT_DIR, d)
              for d in os.listdir(_DEFAULT_DIR)] if
             os.path.isdir(_DEFAULT_DIR) else [])
    n = 0
    for root in roots:
        path = _pidfile(root)
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                pids = json.load(f)
        except (OSError, ValueError):
            continue
        for entry in pids:
            try:
                os.kill(entry["pid"], signal.SIGTERM)
                n += 1
            except ProcessLookupError:
                pass
        os.unlink(path)
    print(f"stopped {n} process(es)")
    return 0


def cmd_up(args):
    from ray_tpu_torch import launcher

    cfg = launcher.load_cluster_config(args.config_file)
    state = launcher.up(cfg, state_dir=args.state_dir)
    print(f"cluster {cfg['cluster_name']!r} up: "
          f"head at {state['head']['address']}, "
          f"{len(state['workers'])} workers")
    print(f"connect with: ray_tpu_torch.init(address="
          f"{state['head']['address']!r})")
    return 0


def cmd_down(args):
    from ray_tpu_torch import launcher

    state = launcher.down(args.cluster_name, state_dir=args.state_dir)
    n = len(state.get("workers", [])) + (1 if state.get("head") else 0)
    print(f"cluster {args.cluster_name!r} down ({n} nodes terminated)")
    return 0


def cmd_exec(args):
    from ray_tpu_torch import launcher

    cmd = " ".join(args.command)
    if cmd.startswith("-- "):
        cmd = cmd[3:]
    return launcher.exec_on_cluster(args.cluster_name, cmd,
                                    state_dir=args.state_dir)


def cmd_attach(args):
    from ray_tpu_torch import launcher

    return launcher.attach(args.cluster_name, state_dir=args.state_dir)


def cmd_submit(args):
    import ray_tpu_torch as ray
    from ray_tpu_torch.job_submission import JobSubmissionClient

    ray.init(address=args.address)
    client = JobSubmissionClient(args.address)
    entry = args.entrypoint
    if entry and entry[0] == "--":
        entry = entry[1:]
    if not entry:
        print("error: no entrypoint given (use: submit --address A -- cmd)",
              file=sys.stderr)
        return 2
    job_id = client.submit_job(entrypoint=" ".join(entry),
                               submission_id=args.submission_id)
    print(f"submitted {job_id}")
    if args.no_wait:
        return 0
    status = client.wait_until_finished(job_id, timeout=3600)
    print(f"job {job_id}: {status.value}")
    print(client.get_job_logs(job_id), end="")
    return 0 if status.value == "SUCCEEDED" else 1


def cmd_job(args):
    import ray_tpu_torch as ray
    from ray_tpu_torch.job_submission import JobSubmissionClient

    ray.init(address=args.address)
    client = JobSubmissionClient(args.address)
    if args.action == "list":
        for j in client.list_jobs():
            print(f"{j.submission_id}\t{j.status.value}\t{j.entrypoint}")
        return 0
    if not args.id:
        print("error: --id required", file=sys.stderr)
        return 2
    if args.action == "status":
        info = client.get_job_info(args.id)
        print(f"{info.status.value} {info.message}")
    elif args.action == "logs":
        print(client.get_job_logs(args.id), end="")
    elif args.action == "stop":
        print("stopped" if client.stop_job(args.id) else "not found")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ray_tpu_torch.scripts.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address")
    p.add_argument("--node-ip")
    p.add_argument("--num-cpus", type=float)
    p.add_argument("--num-gpus", type=float)
    p.add_argument("--resources")
    p.add_argument("--labels")
    p.add_argument("--session-dir")
    p.add_argument("--address-file")
    p.add_argument("--node-info-file")
    p.add_argument("--block", action="store_true")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("status")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("summary", help="one-screen cluster overview "
                                       "(nodes, actors, ledger task "
                                       "states, objects, alerts)")
    p.add_argument("--address", required=True)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("explain", help="why is this task pending / "
                                       "why was it slow (ledger "
                                       "waterfall + placement verdict)")
    p.add_argument("task_id", help="task id hex (prefix ok)")
    p.add_argument("--address", required=True)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("critpath", help="critical-path analysis over "
                                        "the merged span timeline")
    p.add_argument("--address", required=True)
    p.add_argument("--trace-id", dest="trace_id", default=None,
                   help="one execution's blocking chain (default: "
                        "aggregate across traces)")
    p.add_argument("--limit", type=int, default=20,
                   help="aggregate rows to show")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_critpath)

    p = sub.add_parser("list")
    p.add_argument("kind",
                   choices=["actors", "nodes", "objects", "pgs", "tasks"])
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("memory")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("timeline", help="dump the merged cluster "
                                        "chrome trace")
    p.add_argument("--address", required=True)
    p.add_argument("-o", "--output", default="timeline.json")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("metrics", help="print the cluster-wide "
                                       "Prometheus metrics page")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("alerts", help="print watchtower alerts "
                                      "(active + recent transitions)")
    p.add_argument("--address", required=True)
    p.add_argument("--json", action="store_true")
    p.add_argument("--limit", type=int, default=20,
                   help="transition-history lines to show")
    p.set_defaults(fn=cmd_alerts)

    p = sub.add_parser("profile",
                       help="cluster-wide sampling profile -> "
                            "flamegraph-compatible .collapsed stacks")
    p.add_argument("--address", required=True)
    p.add_argument("-d", "--duration", type=float, default=5.0,
                   help="capture window in seconds (default 5)")
    p.add_argument("--hz", type=float, default=None,
                   help="sampling rate (default 25)")
    p.add_argument("-o", "--output", default="profile.collapsed")
    p.add_argument("--chrome", default=None,
                   help="also write a chrome-trace flame view here")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("debug-dump",
                       help="write a one-call post-mortem directory "
                            "(state listings, memory, serve/llm "
                            "status, timeline, metrics, log tails)")
    p.add_argument("--address", required=True)
    p.add_argument("-o", "--output", default=None,
                   help="output directory (default: timestamped)")
    p.add_argument("--deadline", type=float, default=60.0,
                   help="total wall-time budget in seconds")
    p.set_defaults(fn=cmd_debug_dump)

    p = sub.add_parser("logs",
                       help="search/follow structured cluster logs; "
                            "NODE [FILE] = legacy raw-file mode")
    p.add_argument("node_or_file", nargs="?",
                   help="node id hex prefix (raw-file mode; omit for "
                        "the structured query)")
    p.add_argument("file", nargs="?", help="raw log file name "
                                           "(omit to list)")
    p.add_argument("--address", required=True)
    p.add_argument("--nbytes", type=int, default=64 * 1024)
    p.add_argument("--grep", help="regex over msg/logger")
    p.add_argument("--level",
                   choices=["debug", "info", "warning", "error",
                            "critical"],
                   help="minimum level (a typo must not silently "
                        "widen the filter to info-and-up)")
    p.add_argument("--node", help="node id hex prefix filter")
    p.add_argument("--task", help="task id (hex) filter")
    p.add_argument("--trace-id", dest="trace_id",
                   help="trace id filter (correlates with the merged "
                        "timeline)")
    p.add_argument("--proc", help="worker id (hex12) filter")
    p.add_argument("--tail", type=int, default=100,
                   help="records to show (most recent; default 100)")
    p.add_argument("--window", type=float, default=None,
                   help="trailing window in seconds")
    p.add_argument("-f", "--follow", action="store_true",
                   help="keep streaming new records (exits cleanly "
                        "when the head goes away)")
    p.add_argument("--poll", type=float, default=1.0,
                   help="follow poll interval in seconds")
    p.add_argument("--rpc-timeout", type=float, default=5.0,
                   help="per-query RPC budget")
    p.add_argument("--json", action="store_true",
                   help="raw JSONL records instead of formatted lines")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("stop")
    p.add_argument("--session-dir")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("submit")
    p.add_argument("--address", required=True)
    p.add_argument("--submission-id")
    p.add_argument("--no-wait", action="store_true")
    p.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="-- command to run")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("job")
    p.add_argument("action", choices=["status", "logs", "stop", "list"])
    p.add_argument("--address", required=True)
    p.add_argument("--id")
    p.set_defaults(fn=cmd_job)

    p = sub.add_parser("up", help="boot a cluster from a YAML config")
    p.add_argument("config_file")
    p.add_argument("--state-dir")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="terminate a launched cluster")
    p.add_argument("cluster_name")
    p.add_argument("--state-dir")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("exec", help="run a command with the cluster "
                                    "address exported")
    p.add_argument("cluster_name")
    p.add_argument("command", nargs=argparse.REMAINDER)
    p.add_argument("--state-dir")
    p.set_defaults(fn=cmd_exec)

    p = sub.add_parser("attach", help="interactive shell against the "
                                      "cluster")
    p.add_argument("cluster_name")
    p.add_argument("--state-dir")
    p.set_defaults(fn=cmd_attach)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
