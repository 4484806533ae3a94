"""Serve on the port's cluster runtime (ray_tpu_torch.serve), through
the JAX package's scenarios with their own inputs and assertions:
tests/test_serve.py (14) — deploy and route, function deployments,
load sharing, method routing, HTTP ingress, autoscaling up and down,
composed deployments, the proxy actor, pushed routing updates, handle
versions across redeploys, streaming handles and NDJSON, the per-node
proxy fleet with its state-API metrics, and gRPC ingress (it needs
grpcio; a proxy on a machine without it, such as the card's, is
HTTP-only).

One module-scoped cluster, as the JAX file. Deployment classes are
defined inside the tests, so they travel by value through the port's
pickler. The one change to a scenario: the HTTP test binds the proxy on
port 0 and reads its address (the JAX test's fixed port 18123 could
meet the JAX file's proxy on another test worker).
"""

import json
import urllib.request

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    yield c
    serve.shutdown()
    ray_tpu.shutdown()
    c.shutdown()


def test_deploy_and_call(cluster):
    @serve.deployment(num_replicas=2)
    class Doubler:
        def __init__(self, bias):
            self.bias = bias

        def __call__(self, x):
            return 2 * x + self.bias

    handle = serve.run(Doubler.bind(5), name="doubler")
    results = ray_tpu.get([handle.remote(i) for i in range(10)], timeout=60)
    assert results == [2 * i + 5 for i in range(10)]
    serve.delete("doubler")


def test_function_deployment(cluster):
    @serve.deployment
    def greeter(name):
        return f"hello {name}"

    handle = serve.run(greeter.bind(), name="greet")
    assert ray_tpu.get(handle.remote("tpu"), timeout=60) == "hello tpu"
    serve.delete("greet")


def test_replicas_share_load(cluster):
    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, _):
            return self.pid

    handle = serve.run(WhoAmI.bind(), name="who")
    pids = set(ray_tpu.get([handle.remote(None) for _ in range(20)],
                           timeout=60))
    assert len(pids) == 2  # both replicas served traffic
    serve.delete("who")


def test_method_routing_and_handle_reacquire(cluster):
    @serve.deployment(num_replicas=1)
    class Store:
        def __init__(self):
            self.v = {}

        def put(self, k, val):
            self.v[k] = val
            return "ok"

        def get(self, k):
            return self.v.get(k)

    serve.run(Store.bind(), name="store")
    handle = serve.get_app_handle("store")
    assert ray_tpu.get(handle.method("put")("a", 1), timeout=60) == "ok"
    assert ray_tpu.get(handle.method("get")("a"), timeout=60) == 1
    serve.delete("store")


def test_http_ingress(cluster):
    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return {"echo": payload}

    serve.run(Echo.bind(), name="echo", http_port=0)
    req = urllib.request.Request(
        f"http://{serve.proxy_address()}/echo",
        data=json.dumps({"msg": "hi"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    assert body["result"]["echo"] == {"msg": "hi"}
    serve.delete("echo")


def test_autoscaling_up_and_down(cluster):
    """Replica count tracks load (reference: serve autoscaling on mean
    ongoing requests) and the handle's routing set refreshes."""
    @serve.deployment(
        num_replicas=1,
        max_ongoing_requests=32,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 2.0,
                            "downscale_idle_rounds": 2})
    class Slow:
        def __call__(self, _):
            import time as _t

            _t.sleep(0.4)
            return "ok"

    handle = serve.run(Slow.bind(), name="auto")
    import time

    ctrl = ray_tpu.get_actor("__serve_controller")

    def replica_count():
        return len(ray_tpu.get(ctrl.get_replicas.remote("auto"),
                               timeout=30)["replicas"])

    assert replica_count() == 1
    # sustained burst: keep ~12 requests in flight for a few seconds
    refs = []
    deadline = time.monotonic() + 15
    grew = False
    while time.monotonic() < deadline:
        refs = [r for r in refs
                if not ray_tpu.wait([r], timeout=0)[0]]
        while len(refs) < 12:
            refs.append(handle.remote(None))
        if replica_count() >= 2:
            grew = True
            break
        time.sleep(0.2)
    assert grew, "autoscaler never added a replica under load"
    for r in refs:
        try:
            ray_tpu.get(r, timeout=60)
        except Exception:
            pass
    # idle: scales back toward min
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if replica_count() == 1:
            break
        time.sleep(0.5)
    assert replica_count() == 1
    serve.delete("auto")


# ---------------------------------------------------------------------------
# App graphs / composition + proxy-actor ingress (VERDICT r2 item 10)
# Reference: serve/_private/build_app.py:68, _private/proxy.py
# ---------------------------------------------------------------------------

def test_deployment_composition_pipeline(cluster):
    """Model deployment receives a bound Preprocess app; its replicas
    call it via an injected DeploymentHandle."""

    @serve.deployment(num_replicas=2)
    class Preprocess:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre  # DeploymentHandle injected by the app graph

        def __call__(self, x):
            import ray_tpu_torch as rt

            doubled = rt.get(self.pre.remote(x), timeout=60)
            return doubled + 1

    handle = serve.run(Model.bind(Preprocess.bind()), name="pipeline")
    out = ray_tpu.get([handle.remote(i) for i in range(5)], timeout=60)
    assert out == [2 * i + 1 for i in range(5)]
    serve.delete("pipeline")
    serve.delete("pipeline--Preprocess")


def test_http_ingress_via_proxy_actor(cluster):
    """Two-deployment pipeline served over HTTP by the PROXY ACTOR (a
    non-driver process bound on the node IP)."""
    import json
    import urllib.request

    @serve.deployment
    class Upper:
        def __call__(self, s):
            return s.upper()

    @serve.deployment
    class Greeter:
        def __init__(self, upper):
            self.upper = upper

        def __call__(self, name):
            import ray_tpu_torch as rt

            loud = rt.get(self.upper.remote(name), timeout=60)
            return f"HELLO {loud}"

    serve.run(Greeter.bind(Upper.bind()), name="greet")
    addr = serve.start_proxy(port=0)
    req = urllib.request.Request(
        f"http://{addr}/greet",
        data=json.dumps("world").encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    assert body["result"] == "HELLO WORLD"
    # the proxy is a named actor in its own worker process, not the driver
    assert ray_tpu.get_actor("__serve_proxy") is not None
    serve.delete("greet")
    serve.delete("greet--Upper")


def test_push_updates_routing_staleness(cluster):
    """VERDICT r3 item 9: replica-set changes are PUSHED via the head's
    long-poll pubsub — a live handle converges on the new replica set in
    well under the old 2s poll interval."""
    import time

    @serve.deployment(num_replicas=1)
    class V1:
        def __call__(self, x):
            return "v1"

    @serve.deployment(num_replicas=1)
    class V2:
        def __call__(self, x):
            return "v2"

    handle = serve.run(V1.bind(), name="pushapp")
    assert ray_tpu.get(handle.remote(0), timeout=60) == "v1"

    # redeploy: the old replica dies, the version bumps, and a push (not
    # the 15s fallback poll) must update this existing handle
    serve.run(V2.bind(), name="pushapp")
    t0 = time.monotonic()
    deadline = t0 + 5.0
    got = None
    while time.monotonic() < deadline:
        try:
            got = ray_tpu.get(handle.remote(0), timeout=10)
            if got == "v2":
                break
        except Exception:  # noqa: BLE001
            pass  # old replica mid-teardown
        time.sleep(0.05)
    elapsed = time.monotonic() - t0
    assert got == "v2", f"handle still stale after {elapsed:.1f}s"
    assert elapsed < 4.0, f"push should beat the poll fallback: {elapsed:.1f}s"
    serve.delete("pushapp")


def test_handle_version_monotonic_across_redeploys(cluster):
    """Redeploying must not reset the version handles compare against
    (a version that restarts at 0 makes every handle ignore the new
    replica set forever)."""

    @serve.deployment(num_replicas=1)
    class App:
        def __call__(self, x):
            return x + 1

    serve.run(App.bind(), name="ver")
    ctrl = serve.api._controller()
    v1 = ray_tpu.get(ctrl.get_replicas.remote("ver"), timeout=30)["version"]
    serve.run(App.bind(), name="ver")
    v2 = ray_tpu.get(ctrl.get_replicas.remote("ver"), timeout=30)["version"]
    assert v2 > v1, (v1, v2)
    serve.delete("ver")


# ---------------------------------------------------------------------------
# Streaming responses + per-node proxy fleet (VERDICT r4 item 6)
# Reference: serve/_private/proxy.py (proxy per node, response
# streaming), serve/handle.py (handle.options(stream=True))


def test_streaming_handle(cluster):
    import time

    @serve.deployment
    class Tokens:
        def __call__(self, n):
            for i in range(n):
                yield f"tok{i}"
                time.sleep(0.05)

    h = serve.run(Tokens.bind(), name="tok")
    gen = h.options(stream=True).remote(4)
    t0 = time.monotonic()
    first = ray_tpu.get(next(gen))
    dt = time.monotonic() - t0
    assert first == "tok0"
    assert dt < 2.0, f"first chunk took {dt:.1f}s — not streamed"
    rest = [ray_tpu.get(r) for r in gen]
    assert rest == ["tok1", "tok2", "tok3"]
    serve.delete("tok")


def test_http_streaming_endpoint(cluster):
    import time

    @serve.deployment
    class Chunks:
        def __call__(self, body):
            for i in range(3):
                yield {"chunk": i}
                time.sleep(0.3)

    serve.run(Chunks.bind(), name="chunks")
    addr = serve.start_proxy(port=0)
    url = f"http://{addr}/chunks?stream=1"
    req = urllib.request.Request(
        url, data=b"null", headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    resp = urllib.request.urlopen(req, timeout=60)
    first_line = resp.readline()
    t_first = time.monotonic() - t0
    assert json.loads(first_line)["result"] == {"chunk": 0}
    assert t_first < 3.0, f"first chunk after {t_first:.1f}s — buffered"
    lines = [json.loads(l) for l in resp.read().splitlines() if l.strip()]
    assert [l["result"]["chunk"] for l in lines] == [1, 2]
    serve.delete("chunks")


def test_proxy_fleet_two_nodes_and_state_metrics(cluster):
    """Proxies on BOTH nodes (node-affinity pinned), each serving HTTP,
    with request metrics visible through the state API (reference:
    per-node proxies, _private/proxy.py + default_impl.py)."""
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, body):
            return {"echo": body}

    serve.run(Echo.bind(), name="fleet-echo")
    fleet = serve.start_proxy_fleet(port=0)
    assert len(fleet) >= 2, f"expected >=2 node proxies, got {fleet}"
    node_ids = set(fleet)
    assert len(node_ids) == len(fleet)  # one per distinct node
    for nid, addr in fleet.items():
        req = urllib.request.Request(
            f"http://{addr}/fleet-echo", data=json.dumps(42).encode(),
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert out["result"] == {"echo": 42}
    from ray_tpu_torch.util.state import serve_status

    st = serve_status()
    assert "fleet-echo" in st["apps"]
    by_node = {p["node_id"]: p for p in st["proxies"]}
    for nid in fleet:
        assert by_node[nid]["requests"] >= 1, by_node
    serve.delete("fleet-echo")


def test_grpc_ingress_unary_and_streaming(cluster):
    """gRPC ingress beside HTTP (reference: serve's per-node gRPC
    proxy): unary Predict and server-streaming PredictStreaming, app
    routed by 'application' metadata."""
    import time

    import grpc

    @serve.deployment
    class G:
        def __call__(self, body):
            return {"doubled": (body or 0) * 2}

    @serve.deployment
    class GS:
        def __call__(self, body):
            for i in range(3):
                yield {"i": i}
                time.sleep(0.05)

    serve.run(G.bind(), name="gapp")
    serve.run(GS.bind(), name="gstream")
    serve.start_proxy(port=0)
    addr = serve.grpc_proxy_address()
    channel = grpc.insecure_channel(addr)
    ident = lambda b: b  # noqa: E731
    predict = channel.unary_unary("/ray_tpu.serve.Serve/Predict",
                                  request_serializer=ident,
                                  response_deserializer=ident)
    out = json.loads(predict(json.dumps(21).encode(),
                             metadata=(("application", "gapp"),),
                             timeout=60))
    assert out["result"] == {"doubled": 42}

    stream = channel.unary_stream("/ray_tpu.serve.Serve/PredictStreaming",
                                  request_serializer=ident,
                                  response_deserializer=ident)
    chunks = [json.loads(c)["result"] for c in
              stream(b"null",
                     metadata=(("application", "gstream"),), timeout=60)]
    assert chunks == [{"i": 0}, {"i": 1}, {"i": 2}]

    # unknown app surfaces a gRPC error, not a hang
    with pytest.raises(grpc.RpcError):
        predict(b"1", metadata=(("application", "nope"),), timeout=30)
    # grpc requests visible in proxy metrics
    st = serve.status()
    assert any(p.get("grpc", 0) >= 3 for p in st["proxies"])
    channel.close()
    serve.delete("gapp")
    serve.delete("gstream")
