"""Cluster CLI: the port's copy of the observability commands of
``ray_tpu/scripts/cli.py``.

Reference parity: python/ray/scripts/scripts.py — `ray status`,
`ray list`, `ray timeline`, `ray logs`. Every command reads a running
cluster through the state API. Usage:

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

The cluster commands (`start`, `stop`, `submit`, `job`, `up`, `down`,
`exec`, `attach`) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ray_tpu_torch.scripts.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
