"""State API — programmatic cluster introspection.

Reference parity: ray.util.state (python/ray/util/state/api.py —
list_actors/list_nodes/list_placement_groups; task events feed `ray list
tasks`); cluster_timeline/cluster_metrics expose the merged tracing +
metrics plane (see OBSERVABILITY.md).

The port's copy of ``ray_tpu/util/state.py``: every query goes to the
port's head over its RPC, and ``serve_status``/``llm_status`` to Serve's
controller actor."""

from __future__ import annotations


def _head_call(method: str, msg: dict | None = None,
               address: str | None = None, timeout: float = 30):
    from ray_tpu_torch.core.rpc import RpcClient

    if address is None:
        from ray_tpu_torch.core import api as _api

        rt = _api._runtime
        if rt is None or not hasattr(rt, "head_address"):
            raise RuntimeError("state API needs ray_tpu_torch.init() or an "
                               "explicit head address")
        address = rt.head_address
    return RpcClient.shared().call(address, method, msg or {},
                                   timeout=timeout)


def list_actors(address: str | None = None,
                timeout: float = 30) -> list[dict]:
    return _head_call("list_actors", address=address,
                      timeout=timeout)["actors"]


def list_nodes(address: str | None = None,
               timeout: float = 30) -> list[dict]:
    view = _head_call("cluster_view", address=address, timeout=timeout)
    return [
        {
            "node_id": n["node_id"].hex(),
            "address": n["address"],
            "alive": n["alive"],
            "resources": n["resources"],
            "available": n["available"],
            "labels": n["labels"],
        }
        for n in view["nodes"]
    ]


def list_tasks(address: str | None = None, limit: int = 1000,
               timeout: float = 30) -> list[dict]:
    """Executor-reported task events (reference: `ray list tasks` over
    GcsTaskManager task events)."""
    return _head_call("list_tasks", {"limit": limit},
                      address=address, timeout=timeout)["tasks"]


def task_ledger(task_id: str | None = None, limit: int = 0,
                address: str | None = None, timeout: float = 30) -> dict:
    """The head task lifecycle ledger (the fifth observability pillar):
    per-state counts over the bounded ring plus its drop/spill stats —
    ``{"counts": {state: n}, "stats": {...}}`` — and, when asked, one
    joined record by `task_id` hex prefix (``"record"``, including the
    evicted-to-disk spill) or the last-N record summaries
    (``"records"``). Each record carries the full transition history:
    SUBMITTED → QUEUED → LEASED/SCHEDULED/DISPATCHED → RUNNING →
    FINISHED/FAILED/RETRIED with epoch timestamps and the scheduler's
    last placement verdict."""
    msg: dict = {}
    if task_id:
        msg["task_id"] = task_id
    if limit:
        msg["limit"] = limit
    return _head_call("task_ledger", msg, address=address,
                      timeout=timeout)


def explain_task(task_id: str, address: str | None = None,
                 timeout: float = 15) -> dict:
    """`ray_tpu_torch.scripts.cli explain` — why is this task pending /
    why was it slow.

    The head answers from the ledger (the transition waterfall and the
    scheduler's recorded placement verdict) and, for a task that is
    not yet terminal, fans out to every alive nodelet for live queue
    state (is it queued there, queue position, wait so far, and a
    per-node feasibility table naming which resource/label constraint
    fails where). The fan-out runs under ONE shared deadline — a dead
    node becomes an ``errors`` entry, never a failed query. Returns
    ``{"record", "waterfall", "verdict", "nodes": {node12: {...}},
    "errors": {node12: why}}``."""
    return _head_call("explain_task",
                      {"task_id": task_id, "timeout": timeout},
                      address=address, timeout=timeout + 5)


def critical_path(trace_id: str | None = None, address: str | None = None,
                  timeout: float = 30) -> dict:
    """Critical-path analysis over the head's span buffer (see
    ``ray_tpu_torch.util.critpath``): with a `trace_id`, the blocking chain
    of that one execution (per-edge slack, e2e coverage, the slowest
    entry); without, the aggregate across every trace in the buffer —
    which work blocks executions and for how much total time ("where
    does p99 live")."""
    from ray_tpu_torch.util import critpath as _cp

    spans = _head_call("dump_timeline", address=address,
                       timeout=timeout)["spans"]
    if trace_id:
        return _cp.critical_path(spans, trace_id)
    return _cp.aggregate(spans)


def cluster_metrics(address: str | None = None,
                    timeout: float = 30) -> str:
    """One Prometheus page for the whole cluster: the head scrapes every
    alive nodelet (which fans out to its workers) and injects node/proc
    tags (reference: the dashboard's cluster metrics aggregation)."""
    return _head_call("cluster_metrics", address=address,
                      timeout=timeout)["text"]


def cluster_metrics_history(names=None, window_s: float | None = None,
                            address: str | None = None,
                            timeout: float = 30) -> dict:
    """The head watchtower's retained metric time series: the head
    samples its own cluster-wide scrape every few seconds (default 5s)
    into bounded per-series ring buffers, so rate/derivative questions
    ("is the queue ramping?", "did TTFT p99 move in the last 10min?")
    have history to run against — the substrate an SLO autoscaler
    consumes. Returns ``{"series": [{name, tags, samples: [[epoch_s,
    value], ...]}], "period_s", "series_count", "series_dropped",
    "samples_total"}``; `names` filters to those metric names,
    `window_s` clips to the trailing window. Memory is bounded by a
    series cap (rejected new series are COUNTED in
    ``series_dropped``) times a per-series ring."""
    return _head_call("metrics_history",
                      {"names": list(names) if names else None,
                       "window_s": window_s},
                      address=address, timeout=timeout)


def alerts(address: str | None = None, include_history: bool = True,
           timeout: float = 30) -> dict:
    """The watchtower's structured alerts: ``{"alerts": [...],
    "history": [...], "rules": [...], "autodumps": N}`` — active
    (pending/firing) alerts, the bounded transition history
    (pending→firing→resolved events), and the rule pack being
    evaluated. The same facts surface as
    ``watchtower_alerts_firing{severity}`` on the cluster metrics page
    and through ``ray_tpu_torch.scripts.cli alerts``."""
    return _head_call("alerts", {"history": include_history},
                      address=address, timeout=timeout)


def profile(duration_s: float = 5.0, hz: float | None = None,
            address: str | None = None, include_driver: bool = True,
            timeout: float | None = None) -> dict:
    """Cluster-wide sampling profile: the head arms a capture window in
    every process — head, each alive nodelet, each ready worker — via
    the `profile_capture` fan-out (one shared deadline, the metrics
    scrape shape), and this driver samples itself in parallel. Returns
    ``{"stacks": {collapsed: count}, "samples", "dropped", "procs",
    "errors", "hz", "duration_s"}`` where each collapsed stack is
    prefixed with ``node:<id>;proc:<id>`` pseudo-frames, ready for
    `profiler.collapsed_text` / flamegraph tooling. Dormant processes
    pay nothing outside the window; see OBSERVABILITY.md "Profiling &
    memory attribution" for the capture contract."""
    import threading

    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.util import profiler

    local: dict = {}
    th = None
    if include_driver and _api._runtime is not None:
        def _local_capture():
            local.update(profiler.capture_collapsed(duration_s, hz=hz))

        th = threading.Thread(target=_local_capture, daemon=True,
                              name="profile-driver-capture")
        th.start()
    if timeout is None:
        timeout = float(duration_s) + 30.0
    r = _head_call("profile_capture",
                   {"duration_s": duration_s, "hz": hz},
                   address=address, timeout=timeout)
    if th is not None:
        th.join(timeout=float(duration_s) + 10.0)
    if local:
        r["stacks"] = profiler.merge_collapsed([
            r["stacks"],
            profiler.prefix_stacks(local["stacks"],
                                   "node:driver;proc:driver")])
        r["samples"] += local["samples"]
        r["dropped"] += local["dropped"]
        r["procs"] += 1
    return r


def cpu_attribution(address: str | None = None, top_n: int = 20,
                    timeout: float = 20) -> dict:
    """Per-task / per-actor-method CPU attribution, cluster-wide: every
    worker's exec loop accounts `time.thread_time` deltas by (label,
    kind); this aggregates the tables across all alive nodes and
    returns the top-N by cumulative CPU — ``{"rows": [{label, kind,
    cpu_seconds, calls, procs}], "total_cpu_seconds"}``. The straggler
    question ("which actor method is eating the node?") as a lookup
    instead of a profiling session."""
    from ray_tpu_torch.core.rpc import RpcClient

    agg: dict[tuple, dict] = {}
    for n in list_nodes(address, timeout=timeout):
        if not n["alive"]:
            continue
        try:
            r = RpcClient.shared().call(n["address"], "node_cpu_stats",
                                        {}, timeout=timeout)
        except Exception:  # noqa: BLE001
            continue
        for row in r.get("rows", ()):
            key = (row["label"], row["kind"])
            ent = agg.setdefault(key, {"label": row["label"],
                                       "kind": row["kind"],
                                       "cpu_seconds": 0.0, "calls": 0,
                                       "procs": 0})
            ent["cpu_seconds"] += row["cpu_seconds"]
            ent["calls"] += row["calls"]
            ent["procs"] += 1
    rows = sorted(agg.values(), key=lambda e: -e["cpu_seconds"])
    return {"rows": rows[:top_n],
            "total_cpu_seconds": sum(e["cpu_seconds"]
                                     for e in agg.values())}


def cluster_timeline(address: str | None = None,
                     filename: str | None = None, timeout: float = 30):
    """The merged cluster chrome trace from the head's span buffer
    (pid = node, tid = worker/thread, epoch-aligned timestamps; spilled
    history merged back in). In a connected driver prefer
    `ray_tpu_torch.timeline()`, which also flushes the driver's own spans
    first."""
    from ray_tpu_torch.utils.events import merge_spans

    spans = _head_call("dump_timeline", address=address,
                       timeout=timeout)["spans"]
    return merge_spans(spans, filename)


def _node_address(node_id: str, address: str | None) -> str:
    for n in list_nodes(address):
        if n["node_id"].startswith(node_id) and n["alive"]:
            return n["address"]
    raise ValueError(f"no live node matching {node_id!r}")


def node_stats(node_id: str, address: str | None = None) -> dict:
    """Per-node agent stats through the nodelet (reference:
    dashboard/agent.py stats collection — loadavg, per-worker RSS,
    store usage)."""
    from ray_tpu_torch.core.rpc import RpcClient

    target = _node_address(node_id, address)
    return RpcClient.shared().call(target, "node_stats", {}, timeout=30)


def list_logs(node_id: str, address: str | None = None) -> list[dict]:
    """Log files on a node (reference: `ray logs` / the dashboard log
    monitor, _private/log_monitor.py:103)."""
    from ray_tpu_torch.core.rpc import RpcClient

    target = _node_address(node_id, address)
    return RpcClient.shared().call(target, "list_logs", {},
                                   timeout=30)["logs"]


def tail_log(node_id: str, file: str, nbytes: int = 64 * 1024,
             offset: int = -1, address: str | None = None):
    """Tail (or incrementally follow via `offset`) one log file on a
    node. Returns (text, end_offset)."""
    from ray_tpu_torch.core.rpc import RpcClient

    target = _node_address(node_id, address)
    value, frames = RpcClient.shared().call_frames(
        target, "tail_log", {"file": file, "nbytes": nbytes,
                             "offset": offset}, timeout=30)
    if not value.get("ok"):
        raise FileNotFoundError(value.get("error", "log unavailable"))
    return frames[0].decode(errors="replace"), value["end_offset"]


def cluster_logs(address: str | None = None, *, level: str | None = None,
                 grep: str | None = None, node: str | None = None,
                 task: str | None = None, trace_id: str | None = None,
                 proc: str | None = None, limit: int = 1000,
                 window_s: float | None = None,
                 offsets: dict | None = None,
                 timeout: float = 15) -> dict:
    """Cluster-wide structured-log query (the fourth observability
    plane): the head fans `log_query` out to every alive nodelet under
    ONE shared deadline and returns the merged, ts-sorted records —
    ``{"records": [...], "errors": {node12: why}, "offsets": {node12:
    {file: cursor}}, "truncated"}``. Cursors are OPAQUE round-trip
    values (currently ``[inode, byte]`` — rotation is detected by file
    identity); pass them back verbatim, never construct them. A
    stopped node costs at most the shared deadline and lands in
    ``errors``; it never fails the query.

    Filters: ``level`` is a minimum severity, ``grep`` a regex over
    msg/logger, ``node`` a node-id hex prefix, ``task``/``trace_id``
    exact ids (the correlation keys every record carries — see
    OBSERVABILITY.md "Logging"), ``window_s`` a trailing wall-clock
    window. Pass a reply's ``offsets`` back in to read only new
    records (the `--follow` primitive)."""
    import time as _time

    if grep:
        # validate HERE: a bad regex raised inside every nodelet's
        # log_query is indistinguishable from N dead nodes
        import re as _re

        try:
            _re.compile(grep)
        except _re.error as e:
            raise ValueError(f"invalid grep regex {grep!r}: {e}") from e
    from ray_tpu_torch.utils.logging import LEVELS

    if level and str(level).lower() not in LEVELS:
        # level_no() ranks unknown names as info — fine for ranking a
        # record, silently wrong as a FILTER ("warn" must not widen
        # the view to info-and-up)
        raise ValueError(f"unknown level {level!r}; one of "
                         f"{sorted(LEVELS)}")
    msg: dict = {"level": level, "grep": grep, "node": node,
                 "task": task, "trace_id": trace_id, "proc": proc,
                 "limit": limit, "offsets": offsets,
                 "timeout": timeout}
    if window_s is not None:
        msg["since"] = _time.time() - float(window_s)
    return _head_call("cluster_logs", msg, address=address,
                      timeout=timeout + 5)


def list_placement_groups(address: str | None = None,
                          timeout: float = 30) -> list[dict]:
    return _head_call("pg_table", address=address,
                      timeout=timeout).get("groups", [])


def _node_object_tables(address: str | None, timeout: float = 20
                        ) -> tuple[list[dict], list[dict]]:
    """One fan-out pass: (per-node rows incl. store stats, all owned
    objects — workers' via their nodelet + the calling driver's own).
    `timeout` bounds each per-node call (a dead-but-not-yet-aged node
    costs at most that)."""
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.core.rpc import RpcClient

    objects: list[dict] = []
    rt = _api._runtime
    if rt is not None and hasattr(rt, "_h_list_objects"):
        objects.extend(rt._h_list_objects({}, [])["objects"])
    nodes = []
    for n in list_nodes(address, timeout=timeout):
        if not n["alive"]:
            continue
        try:
            r = RpcClient.shared().call(n["address"], "list_node_objects",
                                        {}, timeout=timeout)
        except Exception:  # noqa: BLE001
            continue
        objects.extend(r.get("objects", ()))
        store = r.get("store", {})
        nodes.append({
            "node_id": n["node_id"],
            "address": n["address"],
            "store_bytes_allocated": store.get("bytes_allocated", 0),
            "store_capacity": store.get("capacity", 0),
            "store_num_objects": store.get("num_objects", 0),
            "store_evictions": store.get("evictions", 0),
            "oom_kills": r.get("oom_kills", 0),
        })
    return nodes, objects


def list_objects(address: str | None = None,
                 timeout: float = 20) -> list[dict]:
    """Cluster-wide owner-side object tables (reference:
    `ray list objects`, python/ray/util/state/api.py:1). Covers every
    worker's owned objects via its nodelet, plus the calling driver's
    own table."""
    return _node_object_tables(address, timeout)[1]


_AGE_BUCKETS = ((60.0, "<1m"), (300.0, "1-5m"), (float("inf"), ">5m"))


def _age_bucket(age_s: float) -> str:
    for bound, name in _AGE_BUCKETS:
        if age_s < bound:
            return name
    return _AGE_BUCKETS[-1][1]


def _attr_agg(table: dict, key: str, o: dict, stranded: bool) -> None:
    agg = table.setdefault(key, {
        "count": 0, "bytes": 0, "spilled": 0, "borrowed": 0,
        "stranded_count": 0, "stranded_bytes": 0,
        "ages": {name: 0 for _, name in _AGE_BUCKETS}})
    size = o.get("size", 0) or 0
    agg["count"] += 1
    agg["bytes"] += size
    agg["spilled"] += 1 if o.get("spilled") else 0
    agg["borrowed"] += o.get("borrowers", 0)
    agg["ages"][_age_bucket(o.get("age_s", 0.0))] += 1
    if stranded:
        agg["stranded_count"] += 1
        agg["stranded_bytes"] += size


def memory_summary(address: str | None = None, timeout: float = 20,
                   stranded_age_s: float | None = None) -> dict:
    """Per-node store usage + per-owner AND per-creator object
    attribution with age buckets and the stranded-ref audit (reference:
    the `ray memory` report). A ref counts as STRANDED when it is
    ready, older than `stranded_age_s` (default
    ``RAY_TPU_STRANDED_AGE_S``, 300s), and shows no consumer progress —
    never get()-consumed, never served to a borrower, no live
    borrower. `by_label` groups by what CREATED the object (task /
    actor-method name, `put`, `deferred`), which is what names the
    leaking code path."""
    from ray_tpu_torch.core.cluster_runtime import _stranded_age_s, is_stranded

    if stranded_age_s is None:
        stranded_age_s = _stranded_age_s()
    nodes, objects = _node_object_tables(address, timeout)
    by_owner: dict[str, dict] = {}
    by_label: dict[str, dict] = {}
    stranded_rows: list[dict] = []
    for o in objects:
        # the ONE predicate the auditor gauge uses — report and alert
        # can never disagree about what counts as stranded
        stranded = is_stranded(o.get("ready", False),
                               o.get("consumed", False),
                               o.get("borrowers", 0),
                               o.get("age_s", 0.0), stranded_age_s)
        _attr_agg(by_owner, o["owner"], o, stranded)
        _attr_agg(by_label, o.get("label") or "?", o, stranded)
        if stranded:
            stranded_rows.append(o)
    stranded_rows.sort(key=lambda o: -(o.get("size", 0) or 0))
    return {
        "nodes": nodes,
        "objects_total": len(objects),
        "objects_bytes": sum((o.get("size") or 0) for o in objects),
        "by_owner": by_owner,
        "by_label": by_label,
        "stranded_age_s": stranded_age_s,
        "stranded": {
            "count": len(stranded_rows),
            "bytes": sum((o.get("size") or 0) for o in stranded_rows),
            "top": stranded_rows[:20],
        },
    }


def _attr_lines(title: str, table: dict) -> list[str]:
    lines = [title]
    for key, agg in sorted(table.items(), key=lambda kv: -kv[1]["bytes"]):
        ages = " ".join(f"{name}={agg['ages'][name]}"
                        for _, name in _AGE_BUCKETS)
        lines.append(
            f"  {key:<28} count={agg['count']:<6} "
            f"bytes={agg['bytes'] / (1 << 20):8.1f}MB "
            f"spilled={agg['spilled']:<4} borrowed={agg['borrowed']:<4} "
            f"stranded={agg['stranded_count']:<4} ages[{ages}]")
    return lines


def memory_report(address: str | None = None, timeout: float = 20,
                  stranded_age_s: float | None = None) -> str:
    """Human-readable `ray_tpu_torch.scripts.cli memory` view: per-node
    store usage, the per-owner and per-creator attribution tables, and
    the stranded-ref audit."""
    s = memory_summary(address, timeout, stranded_age_s)
    lines = ["=== object store per node ==="]
    for n in s["nodes"]:
        cap = n["store_capacity"] or 1
        lines.append(
            f"  {n['node_id'][:12]} {n['address']:<21} "
            f"{n['store_bytes_allocated'] / (1 << 20):8.1f}MB / "
            f"{cap / (1 << 20):7.1f}MB  objs={n['store_num_objects']:<6} "
            f"evictions={n['store_evictions']:<6} "
            f"oom_kills={n['oom_kills']}")
    lines.append(f"=== owned objects: {s['objects_total']} "
                 f"({s['objects_bytes'] / (1 << 20):.1f}MB) ===")
    lines += _attr_lines("=== by owner ===", s["by_owner"])
    lines += _attr_lines("=== by creator ===", s["by_label"])
    st = s["stranded"]
    lines.append(
        f"=== stranded refs (age > {s['stranded_age_s']:g}s, no consumer "
        f"progress): {st['count']} ({st['bytes'] / (1 << 20):.1f}MB) ===")
    for o in st["top"]:
        lines.append(
            f"  {o['object_id'][:16]} label={o.get('label', '?'):<24} "
            f"owner={o['owner']:<21} "
            f"bytes={(o.get('size') or 0) / (1 << 20):8.1f}MB "
            f"age={o.get('age_s', 0.0):8.1f}s "
            f"error={bool(o.get('error'))}")
    return "\n".join(lines)


def summarize(address: str | None = None) -> dict:
    nodes = list_nodes(address)
    actors = list_actors(address)
    total: dict[str, float] = {}
    avail: dict[str, float] = {}
    for n in nodes:
        if not n["alive"]:
            continue
        for r, q in n["resources"].items():
            total[r] = total.get(r, 0.0) + q
        for r, q in n["available"].items():
            avail[r] = avail.get(r, 0.0) + q
    return {
        "nodes_alive": sum(1 for n in nodes if n["alive"]),
        "nodes_dead": sum(1 for n in nodes if not n["alive"]),
        "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
        "actors_total": len(actors),
        "resources_total": total,
        "resources_available": avail,
    }


def cluster_summary(address: str | None = None,
                    timeout: float = 20) -> dict:
    """One-screen cluster overview (`ray_tpu_torch.scripts.cli summary`): nodes
    alive/dead, actors by state, ledger task counts by lifecycle
    state, object totals + stranded bytes, and firing alerts — each
    section best-effort (a failed collector becomes an ``errors``
    entry, the rest of the screen still renders)."""
    out: dict = {"errors": {}}

    def section(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001
            out["errors"][name] = repr(e)

    section("cluster", lambda: summarize(address))

    def _actors():
        by_state: dict[str, int] = {}
        for a in list_actors(address, timeout=timeout):
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        return by_state

    section("actors_by_state", _actors)
    section("tasks", lambda: task_ledger(address=address, timeout=timeout))

    def _objects():
        m = memory_summary(address, timeout=timeout)
        return {"objects_total": m["objects_total"],
                "objects_bytes": m["objects_bytes"],
                "stranded_count": m["stranded"]["count"],
                "stranded_bytes": m["stranded"]["bytes"]}

    section("objects", _objects)

    def _alerts():
        r = alerts(address, include_history=False, timeout=timeout)
        return [a for a in r.get("alerts", ())
                if a.get("state") in ("pending", "firing")]

    section("alerts", _alerts)
    return out


def serve_status(address: str | None = None) -> dict:
    """Serve apps + per-replica health + per-proxy request metrics
    (reference: `ray serve status` / the serve state surface). The
    ``health`` key carries the self-healing plane's per-app view —
    live replicas with probe-miss counts, restart totals, degraded
    flags, and the bounded replica lifecycle history (deaths with
    reasons, replacements, restart-cap events) — so a post-mortem can
    reconstruct WHEN each replica died and why. The serve control
    plane lives in actors, so this needs a runtime: with `address`
    given it connects to that head when no runtime exists, and refuses
    to silently answer from a DIFFERENT cluster than the one asked
    about."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve

    if address is not None:
        if not ray.is_initialized():
            ray.init(address=address)
        else:
            from ray_tpu_torch.core.api import _global_runtime

            current = getattr(_global_runtime(), "head_address", None)
            if current is not None and current != address:
                raise ValueError(
                    f"runtime is connected to {current!r}, not "
                    f"{address!r}; serve status reflects the connected "
                    "cluster")
    return serve.status()


def llm_status(app_name: str, timeout: float = 30) -> list[dict]:
    """Per-replica LLM engine stats for a `serve.llm` app: queue depth,
    running lanes, cache utilization, preemptions, weight version,
    cumulative request-phase seconds. One dict per replica (the handle
    routes to a single replica; this asks the controller for the full
    set). Probes ride the replicas' control concurrency group, so they
    answer even while every request lane is mid-stream. `timeout`
    bounds EACH of the two round trips (controller, then replicas)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.serve.api import _CONTROLLER_NAME

    ctrl = ray.get_actor(_CONTROLLER_NAME)
    r = ray.get(ctrl.get_replicas.remote(app_name), timeout=timeout)
    if not r["replicas"]:
        raise ValueError(f"no serve application named {app_name!r}")
    refs = [rep.handle_request.options(
        concurrency_group="control").remote("engine_stats", (), {})
        for rep in r["replicas"]]
    return ray.get(refs, timeout=timeout)


# --------------------------------------------------------------------------
# Flight recorder — `debug_dump()` / `ray_tpu_torch.scripts.cli debug-dump`
# --------------------------------------------------------------------------

def debug_dump(out_dir: str | None = None, address: str | None = None,
               deadline_s: float = 60.0, log_tail_bytes: int = 64 * 1024
               ) -> str:
    """One-call cluster flight recorder: write a post-mortem directory
    with everything an incident writeup needs — state-API listings
    (nodes/actors/tasks/objects/placement groups), the memory report,
    serve + llm status, the merged cluster timeline, the cluster-wide
    /metrics page, and per-node log tails.

    Every artifact is gathered best-effort under ONE deadline: each RPC
    gets at most min(10s, remaining budget), a dead or hung node costs
    its timeout and nothing more, and the dump itself never raises —
    per-artifact failures land in ``summary.json`` next to the
    successes. The one exception is ``serve.status()``, whose internal
    probes carry fixed 10-30s timeouts; it is only attempted while >15s
    of budget remains. Returns the output directory path.

    Layout::

        <dir>/summary.json              what was captured, what failed
        <dir>/nodes.json ...            state listings
        <dir>/memory.txt                the CLI's `memory` report
        <dir>/serve_status.json         serve apps (when serve is up)
        <dir>/llm_status.json           per-replica engine stats
        <dir>/timeline.json             merged chrome trace
        <dir>/metrics.prom              cluster Prometheus page
        <dir>/alerts.json               watchtower alerts + transitions
        <dir>/profile.collapsed         short cluster stack capture
        <dir>/logs/<node12>/<file>      per-node log tails

    ``memory.txt`` is the full attribution report (per-owner +
    per-creator tables, age buckets, the stranded-ref audit);
    ``profile.collapsed`` is a best-effort ~2s cluster-wide sampling
    capture (flamegraph-compatible), taken only while real budget
    remains — success or failure lands in ``summary.json`` like every
    other artifact.
    """
    import json
    import os
    import time

    t_wall = time.time()
    t0 = time.monotonic()
    deadline = t0 + deadline_s
    if out_dir is None:
        out_dir = time.strftime("ray_tpu_torch-debug-%Y%m%d-%H%M%S")
    os.makedirs(out_dir, exist_ok=True)
    summary: dict = {"started_at": t_wall, "deadline_s": deadline_s,
                     "address": address, "artifacts": {}, "errors": {}}

    def budget(cap: float = 10.0) -> float:
        return max(0.5, min(cap, deadline - time.monotonic()))

    def step(name: str, fn, writer=None):
        """Run one artifact collector under the shared deadline; record
        its outcome, never raise."""
        if time.monotonic() >= deadline:
            summary["errors"][name] = "deadline exhausted"
            return None
        t_a = time.monotonic()
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001
            summary["errors"][name] = repr(e)
            return None
        try:
            if writer is not None:
                writer(value)
        except Exception as e:  # noqa: BLE001
            summary["errors"][name] = f"write failed: {e!r}"
            return value
        summary["artifacts"][name] = round(time.monotonic() - t_a, 3)
        return value

    def jwrite(fname):
        def w(value):
            with open(os.path.join(out_dir, fname), "w") as f:
                json.dump(value, f, indent=1, default=str)
        return w

    def twrite(fname):
        def w(text):
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(text)
        return w

    nodes = step("nodes",
                 lambda: list_nodes(address, timeout=budget()),
                 jwrite("nodes.json"))
    step("actors", lambda: list_actors(address, timeout=budget()),
         jwrite("actors.json"))
    step("tasks", lambda: list_tasks(address, timeout=budget()),
         jwrite("tasks.json"))

    # ledger records as JSONL: the joined per-task state machines with
    # transition history — the first artifact a "why did task X stall"
    # post-mortem greps (tasks.json above stays the flat event view)
    def _task_ledger():
        r = task_ledger(limit=2000, address=address, timeout=budget())
        lines = [json.dumps(rec, default=str)
                 for rec in r.get("records", ())]
        return "\n".join(lines) + ("\n" if lines else "")

    step("task_ledger", _task_ledger, twrite("tasks.jsonl"))
    step("placement_groups",
         lambda: list_placement_groups(address, timeout=budget()),
         jwrite("placement_groups.json"))
    step("objects", lambda: list_objects(address, timeout=budget()),
         jwrite("objects.json"))
    step("memory", lambda: memory_report(address, timeout=budget()),
         twrite("memory.txt"))
    step("metrics", lambda: cluster_metrics(address, timeout=budget()),
         twrite("metrics.prom"))
    step("alerts", lambda: alerts(address, timeout=budget()),
         jwrite("alerts.json"))
    step("timeline",
         lambda: cluster_timeline(
             address, os.path.join(out_dir, "timeline.json"),
             timeout=budget()))

    # incident-window structured logs: the last ~10min of records at
    # warning-and-up, cluster-wide and trace/task-tagged — the filtered
    # view an incident writeup greps FIRST (the raw per-node tails
    # below stay for everything the structured plane did not capture)
    def _cluster_logs():
        r = cluster_logs(address, level="warning", window_s=600.0,
                         limit=2000, timeout=budget())
        lines = [json.dumps(rec, default=str) for rec in r["records"]]
        for nid, err in r.get("errors", {}).items():
            summary["errors"][f"cluster_logs:{nid}"] = err
        return "\n".join(lines) + ("\n" if lines else "")

    step("cluster_logs", _cluster_logs, twrite("logs.jsonl"))

    # short cluster profile: where every process's threads were while
    # the incident was live (the alert-triggered autodump path rides
    # this too, so a critical firing captures a flamegraph for free).
    # The capture costs its window in wall time, so it runs only while
    # real budget remains beyond the window.
    if deadline - time.monotonic() > 8.0:
        def _profile():
            from ray_tpu_torch.util import profiler

            # the remaining dump budget bounds the whole capture RPC —
            # a hung node must cost this STEP its timeout, never
            # stretch the dump past deadline_s like every other step
            r = profile(duration_s=min(2.0, budget(5.0) / 2),
                        address=address, timeout=budget())
            return profiler.collapsed_text(r["stacks"])

        step("profile", _profile, twrite("profile.collapsed"))
    else:
        summary["errors"]["profile"] = "insufficient budget left"

    # serve control plane (needs a connected runtime; absent serve apps
    # are an error entry, not a failure). serve.status()'s internal
    # probes carry their own 10-30s timeouts which this step cannot
    # shorten, so it is attempted only while a real budget remains —
    # a hung controller must not stretch the dump to multiples of the
    # deadline.
    status = None
    if deadline - time.monotonic() > 15.0:
        status = step("serve_status", lambda: serve_status(address),
                      jwrite("serve_status.json"))
    else:
        summary["errors"]["serve_status"] = "insufficient budget left"
    if status:
        def _llm():
            out = {}
            for app in status.get("apps", {}):
                if time.monotonic() >= deadline:
                    break
                try:
                    out[app] = llm_status(app, timeout=budget())
                except Exception:  # noqa: BLE001
                    continue  # not an LLM app (or replicas gone)
            return out

        step("llm_status", _llm, jwrite("llm_status.json"))

    # per-node log tails (alive nodes only: a dead nodelet has no RPC
    # endpoint to tail from — its logs are on its disk)
    from ray_tpu_torch.core.rpc import RpcClient

    for n in nodes or []:
        if not n.get("alive"):
            summary["errors"][f"logs:{n['node_id'][:12]}"] = "node dead"
            continue
        nid = n["node_id"][:12]

        def _tail_node(n=n, nid=nid):
            node_dir = os.path.join(out_dir, "logs", nid)
            os.makedirs(node_dir, exist_ok=True)
            logs = RpcClient.shared().call(
                n["address"], "list_logs", {},
                timeout=budget(5.0))["logs"]
            for entry in logs[:50]:
                if time.monotonic() >= deadline:
                    break
                try:
                    value, frames = RpcClient.shared().call_frames(
                        n["address"], "tail_log",
                        {"file": entry["file"],
                         "nbytes": log_tail_bytes, "offset": -1},
                        timeout=budget(5.0))
                    if value.get("ok"):
                        with open(os.path.join(node_dir, entry["file"]),
                                  "wb") as f:
                            f.write(frames[0])
                except Exception:  # noqa: BLE001
                    continue
            return len(logs)

        step(f"logs:{nid}", _tail_node)

    summary["elapsed_s"] = round(time.monotonic() - t0, 3)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return out_dir
