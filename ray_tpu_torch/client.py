"""Ray-Client-style remote drivers: drive a cluster from OUTSIDE it.

Reference parity: python/ray/util/client/ (worker.py:81 — the thin
client mirroring the ray API over a connection; server/proxier.py —
a proxy that spawns ONE dedicated server per client so clients are
isolated from each other) and src/ray/protobuf/ray_client.proto:325
(the put/get/task/actor RPC surface). Redesign on this runtime's own
transport: the proxy (`ClientProxy`) listens on a well-known port; on
connect it spawns a per-client HOST process on the cluster (a full
driver-mode ClusterRuntime with local shm-store access) and hands the
client its address; the thin client (`ClientContext`) then talks to
its host directly with pickled frames. The thin client needs NO
nodelet, NO shm store, NO cluster-routable object plane — exactly the
reference's client-mode contract.

    # on the cluster (e.g. next to the head):
    ray_tpu_torch.client.start_client_server(head_address, port=10001)
    # anywhere with a route to that port:
    ctx = ray_tpu_torch.client.connect("host:10001")
    f = ctx.remote(num_cpus=1)(fn)
    ctx.get(f.remote(3))

The port's copy of ``ray_tpu/client.py``: functions and classes cross
to the host with the port's by-value pickler (``core/serialization``'s
`dumps_fn`/`loads_fn`) where JAX's uses cloudpickle, and the host
processes run ``ray_tpu_torch.client._client_host_main`` with the
checkout's root on PYTHONPATH.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.rpc import RpcClient, RpcServer

_REF = "__client_ref__"
_ACTOR = "__client_actor__"


# ------------------------------------------------------------ host side


class _ClientHost:
    """Per-client server: a real driver runtime executing the thin
    client's commands (reference: one SpecificServer per client,
    util/client/server/proxier.py)."""

    def __init__(self, head_address: str):
        from ray_tpu_torch.core import api as _api

        _api.init(address=head_address)
        self.rt = _api._runtime
        # client-visible state: refs pinned alive on behalf of the client
        self._objects: dict[bytes, object] = {}
        self._actors: dict[bytes, object] = {}
        self._fns: dict[bytes, object] = {}
        self._lock = threading.Lock()
        self._last_seen = time.monotonic()
        s = self.rt.server  # ride the runtime's own RpcServer

        def alive(fn):
            # EVERY client RPC is liveness — without this a client busy
            # with tasks for >idle_timeout would get its host reaped
            def wrapped(msg, frames):
                self._last_seen = time.monotonic()
                return fn(msg, frames)

            return wrapped

        s.register("c_ping", alive(self._h_ping))
        s.register("c_put", alive(self._h_put))
        s.register("c_get", alive(self._h_get), slow=True)
        s.register("c_wait", alive(self._h_wait), slow=True)
        s.register("c_task", alive(self._h_task))
        s.register("c_actor_new", alive(self._h_actor_new))
        s.register("c_actor_call", alive(self._h_actor_call))
        s.register("c_get_actor", alive(self._h_get_actor))
        s.register("c_kill", alive(self._h_kill))
        s.register("c_free", alive(self._h_free), oneway=True)
        s.register("c_disconnect", self._h_disconnect, oneway=True)

    # -- arg translation -------------------------------------------------

    def _decode(self, v):
        if isinstance(v, dict) and _REF in v:
            with self._lock:
                return self._objects[v[_REF]]
        if isinstance(v, dict) and _ACTOR in v:
            with self._lock:
                return self._actors[v[_ACTOR]]
        return v

    def _track(self, ref) -> dict:
        b = ref.id.binary()
        with self._lock:
            self._objects[b] = ref
        return {_REF: b}

    # -- handlers --------------------------------------------------------

    def _h_ping(self, msg, frames):
        self._last_seen = time.monotonic()
        return {"ok": True, "address": self.rt.address}

    def _h_put(self, msg, frames):
        import ray_tpu_torch as ray

        value = ser.deserialize(memoryview(frames[0]))
        return self._track(ray.put(value))

    def _h_get(self, msg, frames):
        import ray_tpu_torch as ray

        refs = [self._decode(r) for r in msg["refs"]]
        # always a list in, list out; the thin client unwraps singles.
        # Blocking here is the proxy's job: c_get rides the slow lane,
        # and task_done lands on the main pool. v2 index audit: the RPC
        # registry confirms this handler registered slow=True (the
        # reentry analysis therefore excludes its edges — the slow pool
        # can park without starving the control plane)
        # graftlint: disable=async-blocking
        values = ray.get(refs, timeout=msg.get("timeout", 300))
        head, views, total = ser.serialize(values)
        buf = bytearray(total)
        ser.write_into(memoryview(buf), head, views)
        return {"ok": True}, [bytes(buf)]

    def _h_wait(self, msg, frames):
        import ray_tpu_torch as ray

        refs = [self._decode(r) for r in msg["refs"]]
        by_id = {r.id.binary(): m for r, m in zip(refs, msg["refs"])}
        # synchronous proxy on the slow lane, same rationale as c_get
        # (v2 index audit: registered slow=True, excluded from reentry
        # edges)
        # graftlint: disable=async-blocking
        ready, pending = ray.wait(
            refs, num_returns=msg.get("num_returns", 1),
            timeout=msg.get("timeout"))
        return {"ready": [by_id[r.id.binary()] for r in ready],
                "pending": [by_id[r.id.binary()] for r in pending]}

    def _remote_fn(self, blob: bytes, opts: dict):
        import hashlib

        import ray_tpu_torch as ray

        key = hashlib.sha1(blob).digest() + ser.dumps_msg(
            sorted(opts.items()))
        with self._lock:
            fn = self._fns.get(key)
        if fn is None:
            fn = ray.remote(**opts)(ser.loads_fn(blob))
            with self._lock:
                self._fns[key] = fn
        return fn

    def _h_task(self, msg, frames):
        fn = self._remote_fn(frames[0], msg.get("opts") or {})
        args = [self._decode(a) for a in msg.get("args", ())]
        kwargs = {k: self._decode(v)
                  for k, v in (msg.get("kwargs") or {}).items()}
        out = fn.remote(*args, **kwargs)
        refs = out if isinstance(out, list) else [out]
        return {"refs": [self._track(r) for r in refs],
                "single": not isinstance(out, list)}

    def _h_actor_new(self, msg, frames):
        import ray_tpu_torch as ray

        cls = ser.loads_fn(frames[0])
        actor_cls = ray.remote(**(msg.get("opts") or {}))(cls)
        copts = msg.get("actor_opts") or {}
        if copts:
            actor_cls = actor_cls.options(**copts)
        args = [self._decode(a) for a in msg.get("args", ())]
        kwargs = {k: self._decode(v)
                  for k, v in (msg.get("kwargs") or {}).items()}
        handle = actor_cls.remote(*args, **kwargs)
        b = handle._actor_id.binary()
        with self._lock:
            self._actors[b] = handle
        return {_ACTOR: b}

    def _h_get_actor(self, msg, frames):
        import ray_tpu_torch as ray

        handle = ray.get_actor(msg["name"])
        b = handle._actor_id.binary()
        with self._lock:
            self._actors[b] = handle
        return {_ACTOR: b}

    def _h_actor_call(self, msg, frames):
        with self._lock:
            handle = self._actors[msg["actor"]]
        args = [self._decode(a) for a in msg.get("args", ())]
        kwargs = {k: self._decode(v)
                  for k, v in (msg.get("kwargs") or {}).items()}
        ref = getattr(handle, msg["method"]).remote(*args, **kwargs)
        return self._track(ref)

    def _h_kill(self, msg, frames):
        import ray_tpu_torch as ray

        with self._lock:
            handle = self._actors.pop(msg["actor"], None)
        if handle is not None:
            ray.kill(handle)
        return {"ok": handle is not None}

    def _h_free(self, msg, frames):
        with self._lock:
            for b in msg.get("refs", ()):
                self._objects.pop(b, None)

    def _h_disconnect(self, msg, frames):
        threading.Thread(target=self._shutdown, daemon=True).start()

    def _shutdown(self):
        time.sleep(0.2)  # let the oneway's socket settle
        try:
            # return leases / free owned objects so the cluster's
            # resources release NOW, not at lease-TTL expiry
            self.rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        # lease returns are SYNCHRONOUS inside shutdown() (the reply is
        # the delivery guarantee); this beat only gives zmq's io thread
        # a chance to push the remaining best-effort oneways (frees,
        # disconnect acks) before the process dies
        time.sleep(0.1)
        os._exit(0)

    def serve_forever(self, idle_timeout_s: float = 300.0):
        while True:
            time.sleep(5.0)
            if time.monotonic() - self._last_seen > idle_timeout_s:
                self._shutdown()  # orphaned client host


def _client_host_main():
    head = os.environ["RAY_TPU_HEAD_ADDR"]
    host = _ClientHost(head)
    # hand our address to the spawning proxy over stdout — PROTOCOL
    # output the parent parses line-by-line, not logging
    # graftlint: disable=bare-print
    print(f"CLIENT_HOST_ADDR {host.rt.address}", flush=True)
    # the proxy stops reading this pipe after the handshake line: any
    # later stdout (e.g. worker prints mirrored here under
    # RAY_TPU_LOG_TO_DRIVER) would fill the ~64KB pipe and BLOCK the
    # writing RPC thread forever — detach to devnull; the runtime's
    # bounded mirror ring still retains mirrored lines for the client
    sys.stdout = open(os.devnull, "w")
    host.serve_forever()


# ------------------------------------------------------------ proxy


class ClientProxy:
    """Well-known-port proxy: `client_connect` spawns a dedicated host
    process per client (reference: proxier.py)."""

    def __init__(self, head_address: str, port: int = 0):
        # port is advisory: the RpcServer binds a random port and
        # `.address` is authoritative (operators publish it the same way
        # they publish the head address). A fixed listen port would need
        # a bind option on RpcServer; deferred until something needs it.
        del port
        self.head_address = head_address
        self.server = RpcServer(name="client-proxy")
        self.server.register("client_connect", self._h_connect, slow=True)
        self.server.register("ping", lambda m, f: "pong")
        self.server.start()
        self.address = self.server.address
        self._procs: list[subprocess.Popen] = []

    def _h_connect(self, msg, frames):
        env = dict(os.environ, RAY_TPU_HEAD_ADDR=self.head_address)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "from ray_tpu_torch.client import _client_host_main; "
             "_client_host_main()"],
            env=env, stdout=subprocess.PIPE, text=True)
        # reap exited client hosts so the list tracks live processes
        # only (it otherwise grows by one per connect, forever)
        self._procs = [p for p in self._procs if p.poll() is None]
        self._procs.append(proc)
        deadline = time.monotonic() + 60
        addr = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.startswith("CLIENT_HOST_ADDR "):
                addr = line.split(" ", 1)[1].strip()
                break
            if proc.poll() is not None:
                break
        if addr is None:
            raise RuntimeError("client host failed to start")
        return {"host": addr}

    def stop(self):
        self.server.stop()
        for p in self._procs:
            try:
                p.kill()
            except Exception:  # noqa: BLE001
                pass


def start_client_server(head_address: str, port: int = 0) -> ClientProxy:
    """Start the client proxy next to the cluster; returns the proxy
    (its .address is what remote clients connect to)."""
    return ClientProxy(head_address, port)


# ------------------------------------------------------------ thin client


class ClientObjectRef:
    __slots__ = ("ctx", "id")

    def __init__(self, ctx, ref_id: bytes):
        self.ctx = ctx
        self.id = ref_id

    def _wire(self):
        return {_REF: self.id}

    def __del__(self):
        try:
            self.ctx._free(self.id)
        except Exception:  # noqa: BLE001
            pass

    def __repr__(self):
        return f"ClientObjectRef({self.id.hex()[:12]})"


class _ClientMethod:
    def __init__(self, ctx, actor_id: bytes, name: str):
        self._ctx = ctx
        self._actor = actor_id
        self._name = name

    def remote(self, *args, **kwargs):
        ctx = self._ctx
        r = ctx._call("c_actor_call", {
            "actor": self._actor, "method": self._name,
            "args": [ctx._encode(a) for a in args],
            "kwargs": {k: ctx._encode(v) for k, v in kwargs.items()},
        })
        return ClientObjectRef(ctx, r[_REF])


class ClientActorHandle:
    def __init__(self, ctx, actor_id: bytes):
        self._ctx = ctx
        self._actor_id = actor_id

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClientMethod(self._ctx, self._actor_id, name)


class _ClientActorClass:
    def __init__(self, ctx, cls, opts: dict):
        self._ctx = ctx
        self._blob = ser.dumps_fn(cls)
        self._opts = opts
        self._actor_opts: dict = {}

    def options(self, **kw) -> "_ClientActorClass":
        out = _ClientActorClass.__new__(_ClientActorClass)
        out._ctx, out._blob = self._ctx, self._blob
        out._opts = dict(self._opts)
        out._actor_opts = {**self._actor_opts, **kw}
        return out

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        ctx = self._ctx
        r = ctx._call("c_actor_new", {
            "opts": self._opts, "actor_opts": self._actor_opts,
            "args": [ctx._encode(a) for a in args],
            "kwargs": {k: ctx._encode(v) for k, v in kwargs.items()},
        }, frames=[self._blob])
        return ClientActorHandle(ctx, r[_ACTOR])


class _ClientRemoteFunction:
    def __init__(self, ctx, fn, opts: dict):
        self._ctx = ctx
        self._blob = ser.dumps_fn(fn)
        self._opts = opts

    def remote(self, *args, **kwargs):
        ctx = self._ctx
        r = ctx._call("c_task", {
            "opts": self._opts,
            "args": [ctx._encode(a) for a in args],
            "kwargs": {k: ctx._encode(v) for k, v in kwargs.items()},
        }, frames=[self._blob])
        refs = [ClientObjectRef(ctx, e[_REF]) for e in r["refs"]]
        return refs[0] if r["single"] else refs


class ClientContext:
    """The thin client (reference: util/client/worker.py Worker)."""

    def __init__(self, address: str, timeout: float = 30.0):
        self._rpc = RpcClient.shared()
        r = self._rpc.call(address, "client_connect", {}, timeout=timeout)
        self._host = r["host"]
        self._rpc.call(self._host, "c_ping", {}, timeout=timeout)
        self._connected = True

    # -- plumbing --------------------------------------------------------

    def _call(self, method, msg, frames=(), timeout: float = 300.0):
        return self._rpc.call(self._host, method, msg, frames=frames,
                              timeout=timeout)

    def _encode(self, v):
        if isinstance(v, ClientObjectRef):
            return v._wire()
        if isinstance(v, ClientActorHandle):
            return {_ACTOR: v._actor_id}
        return v

    def _free(self, ref_id: bytes):
        if self._connected:
            self._rpc.send_oneway(self._host, "c_free", {"refs": [ref_id]})

    # -- mirrored API ----------------------------------------------------

    def remote(self, _fn=None, **opts):
        def wrap(obj):
            if isinstance(obj, type):
                return _ClientActorClass(self, obj, opts)
            return _ClientRemoteFunction(self, obj, opts)

        return wrap(_fn) if _fn is not None else wrap

    def put(self, value) -> ClientObjectRef:
        head, views, total = ser.serialize(value)
        buf = bytearray(total)
        ser.write_into(memoryview(buf), head, views)
        r = self._call("c_put", {}, frames=[bytes(buf)])
        return ClientObjectRef(self, r[_REF])

    def get(self, refs, timeout: float = 300.0):
        single = isinstance(refs, ClientObjectRef)
        lst = [refs] if single else list(refs)
        value, frames = self._rpc.call_frames(
            self._host, "c_get",
            {"refs": [r._wire() for r in lst], "timeout": timeout,
             "as_list": not single},
            timeout=timeout + 10)
        values = ser.deserialize(memoryview(frames[0]))
        return values[0] if single else values

    def wait(self, refs, num_returns: int = 1, timeout=None):
        r = self._call("c_wait", {
            "refs": [x._wire() for x in refs],
            "num_returns": num_returns, "timeout": timeout,
        }, timeout=(timeout or 300) + 10)
        by_id = {x.id: x for x in refs}
        return ([by_id[e[_REF]] for e in r["ready"]],
                [by_id[e[_REF]] for e in r["pending"]])

    def get_actor(self, name: str) -> ClientActorHandle:
        r = self._call("c_get_actor", {"name": name})
        return ClientActorHandle(self, r[_ACTOR])

    def kill(self, handle: ClientActorHandle):
        self._call("c_kill", {"actor": handle._actor_id})

    def disconnect(self):
        if self._connected:
            self._connected = False
            try:
                self._rpc.send_oneway(self._host, "c_disconnect", {})
            except Exception:  # noqa: BLE001
                pass


def connect(address: str) -> ClientContext:
    """Connect to a cluster's client proxy ("host:port" — the ray://
    scheme prefix is accepted and stripped)."""
    if address.startswith("ray://"):
        address = address[len("ray://"):]
    return ClientContext(address)
