"""Dashboard-lite: HTTP view of cluster state.

Reference parity: the dashboard head's REST surface
(python/ray/dashboard/head.py + modules/{node,actor,job}) scoped to the
state endpoints and a minimal auto-refreshing HTML page — no React
frontend. Serves: / (HTML), /api/state, /api/nodes, /api/actors,
/api/pgs, /api/jobs, /api/objects, /api/memory (owner-side object
tables + per-node store usage, the `ray memory` role), /api/history
(ring buffer of cluster summaries, 1h at 5s), /api/train, /api/data,
/api/serve (the libraries' published views), /api/node_stats,
/api/logs, /metrics (this process's Prometheus registry).

The port's copy of ``ray_tpu/dashboard.py``."""

from __future__ import annotations

import json
import threading
import time
from collections import deque

# node-metrics history ring (reference role: the dashboard's metrics
# module keeps time series; here a bounded in-memory ring served at
# /api/history — 720 samples x 5s = 1h)
_HISTORY_MAXLEN = 720
_HISTORY_INTERVAL_S = 5.0
_history: deque = deque(maxlen=_HISTORY_MAXLEN)
_sampler_stop = None

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body { font-family: monospace; margin: 2em; }
 table { border-collapse: collapse; margin-bottom: 2em; }
 td, th { border: 1px solid #999; padding: 4px 10px; text-align: left; }
 h2 { margin-bottom: .3em; }
</style></head>
<body>
<h1>ray_tpu_torch cluster</h1>
<div id="content">loading…</div>
<script>
async function load() {
  const s = await (await fetch('/api/state')).json();
  const nodes = await (await fetch('/api/nodes')).json();
  const actors = await (await fetch('/api/actors')).json();
  const jobs = await (await fetch('/api/jobs')).json();
  let h = '<h2>Summary</h2><table>';
  for (const [k, v] of Object.entries(s))
    h += `<tr><th>${k}</th><td>${JSON.stringify(v)}</td></tr>`;
  h += '</table><h2>Nodes</h2><table><tr><th>id</th><th>address</th>' +
       '<th>alive</th><th>resources</th><th>available</th></tr>';
  for (const n of nodes)
    h += `<tr><td>${n.node_id.slice(0,12)}</td><td>${n.address}</td>` +
         `<td>${n.alive}</td><td>${JSON.stringify(n.resources)}</td>` +
         `<td>${JSON.stringify(n.available)}</td></tr>`;
  h += '</table><h2>Actors</h2><table><tr><th>id</th><th>name</th>' +
       '<th>state</th><th>node</th></tr>';
  for (const a of actors)
    h += `<tr><td>${a.actor_id.slice(0,12)}</td><td>${a.name||''}</td>` +
         `<td>${a.state}</td><td>${(a.node_id||'').slice(0,12)}</td></tr>`;
  h += '</table><h2>Jobs</h2><table><tr><th>id</th><th>status</th>' +
       '<th>entrypoint</th></tr>';
  for (const j of jobs)
    h += `<tr><td>${j.submission_id}</td><td>${j.status}</td>` +
         `<td>${j.entrypoint}</td></tr>`;
  h += '</table>';
  const train = await (await fetch('/api/train')).json();
  h += '<h2>Train runs</h2><table><tr><th>name</th><th>status</th>' +
       '<th>iteration</th><th>workers</th></tr>';
  for (const t of train)
    h += `<tr><td>${t.name}</td><td>${t.status}</td>` +
         `<td>${t.iteration}</td><td>${t.num_workers||''}</td></tr>`;
  h += '</table>';
  const serve = await (await fetch('/api/serve')).json();
  h += '<h2>Serve</h2><pre>' +
       JSON.stringify(serve, null, 1).slice(0, 4000) + '</pre>';
  const data = await (await fetch('/api/data')).json();
  h += '<h2>Data executions</h2><table><tr><th>id</th><th>status</th>' +
       '<th>submitted</th><th>yielded</th></tr>';
  for (const d of data)
    h += `<tr><td>${d.name}</td><td>${d.status}</td>` +
         `<td>${d.submitted}</td><td>${d.yielded}</td></tr>`;
  h += '</table>';
  document.getElementById('content').innerHTML = h;
}
load();
</script></body></html>"""

_server = None

# -------------------------------------------------- subsystem views
# Train/Data publish lightweight run records into the head KV under the
# "dashboard" namespace; /api/train and /api/data list them (reference:
# dashboard/modules/train + modules/data reading subsystem state).


_publish_q: "deque" = deque(maxlen=64)  # drop-oldest when the head lags
_publish_wake = threading.Event()
_publisher_started = False
_publisher_lock = threading.Lock()


def publish_view(kind: str, name: str, payload: dict,
                 address: str | None = None):
    """Best-effort: write one subsystem record into head KV. The RPC
    runs on a background publisher thread (short timeout, drop-oldest
    queue) so a slow or unreachable head can never stall the caller's
    hot loop (train result loop / data executor)."""
    payload = {**payload, "name": name, "updated_at": time.time()}
    _publish_q.append((kind, name, payload, address))
    global _publisher_started
    with _publisher_lock:
        if not _publisher_started:
            _publisher_started = True
            threading.Thread(target=_publish_loop, daemon=True,
                             name="dashboard-publish").start()
    _publish_wake.set()


def _publish_loop():
    from ray_tpu_torch.core.gcs_client import GcsClient

    while True:
        _publish_wake.wait(timeout=5.0)
        _publish_wake.clear()
        while _publish_q:
            try:
                kind, name, payload, address = _publish_q.popleft()
            except IndexError:
                break
            try:
                GcsClient(address, timeout=2.0).internal_kv_put(
                    f"{kind}/{name}",
                    json.dumps(payload, default=str).encode(),
                    namespace="dashboard")
            except Exception:  # noqa: BLE001
                pass  # no cluster runtime / head gone: views are optional


def read_views(kind: str, address: str | None = None) -> list[dict]:
    try:
        from ray_tpu_torch.core.gcs_client import GcsClient

        gcs = GcsClient(address)
        out = []
        for key in gcs.internal_kv_keys(f"{kind}/", namespace="dashboard"):
            raw = gcs.internal_kv_get(key, namespace="dashboard")
            if raw:
                try:
                    out.append(json.loads(raw))
                except ValueError:
                    pass
        out.sort(key=lambda r: r.get("updated_at", 0), reverse=True)
        return out
    except Exception:  # noqa: BLE001
        return []


def _serve_view(head_address) -> dict:
    try:
        from ray_tpu_torch.util.state import serve_status

        return serve_status(head_address)
    except Exception as e:  # noqa: BLE001
        return {"error": repr(e), "apps": {}}


def _sample_loop(head_address, stop: threading.Event):
    from ray_tpu_torch.util import state

    while not stop.wait(_HISTORY_INTERVAL_S):
        try:
            s = state.summarize(head_address)
            _history.append({"time": time.time(), **s})
        except Exception:  # noqa: BLE001
            pass  # head briefly unreachable; the gap itself is the signal


def start_dashboard(head_address: str | None = None, port: int = 8265) -> int:
    """Start the dashboard HTTP server; returns the bound port."""
    global _server, _sampler_stop
    import http.server

    from ray_tpu_torch.util import metrics as metrics_mod
    from ray_tpu_torch.util import state

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/" or self.path == "/index.html":
                    self._send(_PAGE.encode(), "text/html")
                elif self.path == "/api/state":
                    self._send(json.dumps(
                        state.summarize(head_address)).encode(),
                        "application/json")
                elif self.path == "/api/nodes":
                    self._send(json.dumps(
                        state.list_nodes(head_address)).encode(),
                        "application/json")
                elif self.path == "/api/actors":
                    self._send(json.dumps(
                        state.list_actors(head_address)).encode(),
                        "application/json")
                elif self.path == "/api/pgs":
                    self._send(json.dumps(
                        state.list_placement_groups(head_address),
                        default=str).encode(), "application/json")
                elif self.path == "/api/jobs":
                    self._send(json.dumps(_jobs(head_address)).encode(),
                               "application/json")
                elif self.path == "/api/objects":
                    self._send(json.dumps(
                        state.list_objects(head_address)).encode(),
                        "application/json")
                elif self.path == "/api/memory":
                    self._send(json.dumps(
                        state.memory_summary(head_address)).encode(),
                        "application/json")
                elif self.path == "/api/history":
                    self._send(json.dumps(list(_history)).encode(),
                               "application/json")
                elif self.path == "/api/train":
                    self._send(json.dumps(
                        read_views("train", head_address)).encode(),
                        "application/json")
                elif self.path == "/api/data":
                    self._send(json.dumps(
                        read_views("data", head_address)).encode(),
                        "application/json")
                elif self.path == "/api/serve":
                    self._send(json.dumps(
                        _serve_view(head_address), default=str).encode(),
                        "application/json")
                elif self.path.startswith("/api/node_stats"):
                    # /api/node_stats?node=<hex> — the per-node agent
                    # tier through the nodelet (dashboard/agent.py role)
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    node = (q.get("node") or [""])[0]
                    self._send(json.dumps(
                        state.node_stats(node, head_address)).encode(),
                        "application/json")
                elif self.path == "/metrics":
                    self._send(metrics_mod.prometheus_text().encode(),
                               "text/plain; version=0.0.4")
                elif self.path.startswith("/api/logs"):
                    # /api/logs?node=<hex>[&file=<name>[&nbytes=N]]
                    # (reference: dashboard log streaming via the log
                    # monitor, _private/log_monitor.py:103)
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    node = (q.get("node") or [""])[0]
                    fname = (q.get("file") or [None])[0]
                    if fname is None:
                        self._send(json.dumps(
                            state.list_logs(node, head_address)).encode(),
                            "application/json")
                    else:
                        nbytes = int((q.get("nbytes") or ["65536"])[0])
                        text, _ = state.tail_log(node, fname, nbytes,
                                                 address=head_address)
                        self._send(text.encode(), "text/plain")
                else:
                    self._send(b"not found", "text/plain", 404)
            except Exception as e:  # noqa: BLE001
                self._send(json.dumps({"error": repr(e)}).encode(),
                           "application/json", 500)

        def log_message(self, *a):
            pass

    _server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=_server.serve_forever, daemon=True,
                     name="dashboard-http").start()
    _sampler_stop = threading.Event()
    threading.Thread(target=_sample_loop, args=(head_address, _sampler_stop),
                     daemon=True, name="dashboard-sampler").start()
    return _server.server_address[1]


def _jobs(head_address: str | None) -> list[dict]:
    try:
        from ray_tpu_torch.job_submission import JobSubmissionClient

        client = JobSubmissionClient(head_address)
        return [
            {"submission_id": j.submission_id, "status": j.status.value,
             "entrypoint": j.entrypoint}
            for j in client.list_jobs()
        ]
    except Exception:  # noqa: BLE001
        return []


def stop_dashboard():
    global _server, _sampler_stop
    if _sampler_stop is not None:
        _sampler_stop.set()
        _sampler_stop = None
    if _server is not None:
        _server.shutdown()
        _server = None
    _history.clear()
