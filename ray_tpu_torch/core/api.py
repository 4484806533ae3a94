"""Public task/actor/object API: the port's copy of
``ray_tpu/core/api.py``, on the in-process `LocalRuntime`.

Reference parity: ray.init (python/ray/_private/worker.py:1275),
@ray.remote (python/ray/remote_function.py:41, python/ray/actor.py:602),
ray.get/put/wait (worker.py:2636,2804,2869).

Deviations from the JAX package: ``init(num_gpus=)`` in place of
``num_tpus=``; ``init()`` without ``local_mode=True`` raises, since the
cluster runtime is not ported (it does not fall back to local mode); and
`ActorMethod.bind` raises until ``dag/`` is ported.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Sequence

from ray_tpu_torch.core import options as _opt
from ray_tpu_torch.core.ids import ActorID, ObjectID

_runtime = None
_runtime_lock = threading.RLock()


# ---------------------------------------------------------------- ObjectRef


class ObjectRef:
    """A future for a task result or `put` value. Owned by the worker that
    created it (reference: ownership model, core_worker/reference_count.h).

    Each live ObjectRef instance holds one local reference on the
    object's store slot; when the last instance is garbage-collected the
    runtime may free the value (reference: ReferenceCounter local refs,
    core_worker/reference_count.h:66)."""

    __slots__ = ("id", "owner", "__weakref__")

    def __init__(self, id: ObjectID, owner: str | None = None):
        self.id = id
        self.owner = owner
        rt = _runtime
        if rt is not None:
            rt._incref(id, owner)

    def __del__(self):
        rt = _runtime
        if rt is not None:
            try:
                rt._decref(self.id, self.owner)
            except Exception:
                pass

    def hex(self) -> str:
        return self.id.hex()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:12]}…)"

    def __reduce__(self):
        return (ObjectRef, (self.id, self.owner))

    def future(self):
        """concurrent.futures.Future view of this ref."""
        return _global_runtime().as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


class ObjectRefGenerator:
    """Handle for a streaming-generator task (`num_returns="streaming"`).

    Iterating yields one ObjectRef per value the remote generator yields,
    AS the producer yields them — the consumer does not wait for the task
    to finish (reference: ObjectRefStream,
    src/ray/core_worker/task_manager.h:104 and the ObjectRefGenerator in
    python/ray/_raylet.pyx). Picklable: a borrower process iterates by
    asking the stream's owner for each index."""

    __slots__ = ("_task_id", "_owner", "_index", "_done", "_handed_off",
                 "__weakref__")

    def __init__(self, task_id: bytes, owner: str):
        self._task_id = task_id
        self._owner = owner
        self._index = 0
        self._done = False
        self._handed_off = False

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        return self._next_sync(None)

    def _next_sync(self, timeout: float | None = None) -> "ObjectRef":
        """Like __next__ but with a timeout (reference:
        ObjectRefGenerator._next_sync)."""
        if self._done:
            raise StopIteration
        try:
            ref = _global_runtime().stream_next(
                self._task_id, self._owner, self._index, timeout=timeout)
        except StopIteration:
            self._done = True
            raise
        self._index += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration from None

    def close(self):
        """Early termination: tells the owner to drop unconsumed items
        and cancel the producer (reference: stream deletion GC,
        task_manager.h:212)."""
        if self._done:
            return
        self._done = True
        rt = _runtime
        if rt is not None:
            try:
                rt.stream_close(self._task_id, self._owner)
            except Exception:
                pass

    def __del__(self):
        # a handle that was pickled away handed consumption to the
        # borrower copy: closing here would silently truncate its
        # iteration (the borrower's close/exhaustion does the GC instead)
        if not self._handed_off:
            self.close()

    def __reduce__(self):
        self._handed_off = True
        g = (_rebuild_generator, (self._task_id, self._owner, self._index))
        return g

    def __repr__(self):
        return (f"ObjectRefGenerator({self._task_id.hex()[:12]}…, "
                f"index={self._index})")


def _rebuild_generator(task_id: bytes, owner: str, index: int):
    g = ObjectRefGenerator(task_id, owner)
    g._index = index
    return g


# ---------------------------------------------------------------- init


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict[str, float] | None = None,
    local_mode: bool = False,
    namespace: str | None = None,
    labels: dict[str, str] | None = None,
    ignore_reinit_error: bool = False,
    **kwargs,
):
    """Start the runtime. `local_mode=True` runs everything in this
    process (tasks and actors on threads) — same semantics, no
    isolation. Anything else raises: the cluster runtime (a head node,
    nodelets and worker processes) is not ported yet."""
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime.context_info()
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; use shutdown() first")
        from ray_tpu_torch.core.runtime import make_runtime

        _runtime = make_runtime(
            address=address,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources or {},
            local_mode=local_mode,
            namespace=namespace,
            labels=labels or {},
            **kwargs,
        )
        return _runtime.context_info()


def shutdown():
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def _global_runtime():
    global _runtime
    if _runtime is None:
        with _runtime_lock:
            if _runtime is None:
                init()
    return _runtime


# ---------------------------------------------------------------- core verbs


def put(value: Any) -> ObjectRef:
    return _global_runtime().put(value)


def get(refs, timeout: float | None = None):
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    elif not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects ObjectRef or list, got {type(refs)}")
    vals = _global_runtime().get(list(refs), timeout=timeout)
    return vals[0] if single else vals


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns > number of refs")
    return _global_runtime().wait(
        refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    return _global_runtime().cancel(ref, force=force, recursive=recursive)


def kill(actor: "ActorHandle", *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    return _global_runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: str | None = None) -> "ActorHandle":
    return _global_runtime().get_named_actor(name, namespace)


def nodes() -> list[dict]:
    return _global_runtime().nodes()


def cluster_resources() -> dict[str, float]:
    return _global_runtime().cluster_resources()


def available_resources() -> dict[str, float]:
    return _global_runtime().available_resources()


def get_runtime_context():
    return _global_runtime().runtime_context()


def timeline(filename: str | None = None):
    """Export task events as a Chrome trace (reference: `ray timeline`)."""
    return _global_runtime().timeline(filename)


# ---------------------------------------------------------------- @remote


def remote(*args, **kwargs):
    """Decorator turning a function into a RemoteFunction or a class into
    an ActorClass. Usable bare (@remote) or with options
    (@remote(num_cpus=2, num_gpus=1))."""
    if len(args) == 1 and not kwargs and (inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only")

    def wrap(obj):
        return _make_remote(obj, kwargs)

    return wrap


def method(**kwargs):
    """Per-method options on an actor class (reference: ray.method,
    python/ray/actor.py:116)."""

    def wrap(fn):
        fn.__ray_tpu_method_options__ = kwargs
        return fn

    return wrap


def _make_remote(obj, opts: dict):
    if inspect.isclass(obj):
        return ActorClass(obj, _opt.actor_options(opts))
    return RemoteFunction(obj, _opt.task_options(opts))


class RemoteFunction:
    """Reference: python/ray/remote_function.py:41."""

    def __init__(self, fn, opts: _opt.TaskOptions):
        self._fn = fn
        self._opts = opts
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs):
        return _global_runtime().submit_task(self._fn, args, kwargs, self._opts)

    def options(self, **opts):
        merged = {**_asdict_nondefault(self._opts), **opts}
        return RemoteFunction(self._fn, _opt.task_options(merged))

    def __call__(self, *a, **kw):
        raise TypeError(
            f"remote function {self._fn.__name__} cannot be called directly; "
            f"use .remote()"
        )


class ActorClass:
    """Reference: python/ray/actor.py:602."""

    def __init__(self, cls, opts: _opt.ActorOptions):
        self._cls = cls
        self._opts = opts
        functools.update_wrapper(self, cls, updated=[])

    def remote(self, *args, **kwargs) -> "ActorHandle":
        return _global_runtime().create_actor(self._cls, args, kwargs, self._opts)

    def options(self, **opts):
        merged = {**_asdict_nondefault(self._opts), **opts}
        return ActorClass(self._cls, _opt.actor_options(merged))

    def __call__(self, *a, **kw):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use .remote()"
        )


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, opts: dict):
        self._handle = handle
        self._name = name
        self._opts = opts

    def remote(self, *args, **kwargs):
        return _global_runtime().submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs, self._opts
        )

    def bind(self, *args):
        """Bind into a compiled DAG (reference: ray.dag —
        actor.method.bind(node), dag/class_node.py). Raises: ``dag/`` is
        not ported yet."""
        raise NotImplementedError(
            "ActorMethod.bind: compiled graphs (dag/) are not ported to "
            "ray_tpu_torch yet")

    def options(self, **opts):
        return ActorMethod(self._handle, self._name, {**self._opts, **opts})


class ActorHandle:
    """Reference: python/ray/actor.py:1265."""

    def __init__(self, actor_id: ActorID, method_meta: dict[str, dict] | None = None):
        self._actor_id = actor_id
        self._method_meta = method_meta or {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name, self._method_meta.get(name, {}))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]}…)"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_meta))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


def _asdict_nondefault(opts) -> dict:
    import dataclasses

    out = {}
    for f in dataclasses.fields(opts):
        v = getattr(opts, f.name)
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else None
        )
        if v != default:
            out[f.name] = v
    return out
