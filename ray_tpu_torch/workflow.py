"""Durable workflows — crash-resumable DAG execution over tasks.

Reference parity: python/ray/workflow/ (workflow_executor.py:1 — a DAG
of steps executed as tasks with every step result durably logged;
api.py run/resume/list_all; workflow_storage.py — filesystem-backed
step-result store). Redesign: steps are plain ray_tpu tasks; the
executor walks the DAG bottom-up, skipping any step whose result is
already persisted under its DETERMINISTIC step id (name + structural
hash of its inputs), so `resume()` after a crash re-executes only the
unfinished suffix. Storage is a directory tree:

    <storage>/<workflow_id>/
        dag.pkl            # the submitted DAG (enables resume)
        status.json        # RUNNING | SUCCESS | FAILED
        steps/<step_id>.pkl  # one durable result per finished step

The port's copy of ``ray_tpu/workflow.py``. It pickles DAGs and step
results with the port's by-value pickler (``core/serialization``'s
`dumps_fn`/`loads_fn`) where JAX's uses cloudpickle, and its default
storage is ``~/.ray_tpu_torch_workflows``. A step id hashes a code
object by its content (bytecode, names, constants, nested code), never
by marshal's bytes or a repr that holds an address, and every other
input through `_stable_bytes`: so the ids, which differ from JAX's, are
the same in every process, and `resume` in a new driver skips the steps
a crashed one finished.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time
import types
from typing import Any

from ray_tpu_torch.core import serialization as ser

_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_torch_workflows")

RUNNING = "RUNNING"
SUCCESS = "SUCCESS"
FAILED = "FAILED"
RESUMABLE = "RESUMABLE"


class WorkflowError(RuntimeError):
    pass


class StepNode:
    """One DAG node: a function + (possibly nested) inputs. Produced by
    `@workflow.step` functions' `.step(*args)` (reference:
    workflow step decorator / DAG node bind)."""

    def __init__(self, fn, name: str, args: tuple, kwargs: dict,
                 max_retries: int = 0, num_cpus: float = 1.0,
                 timeout_s: float | None = None):
        self.fn = fn
        self.name = name
        self.args = args
        self.kwargs = kwargs
        self.max_retries = max_retries
        self.num_cpus = num_cpus
        self.timeout_s = timeout_s  # None = wait as long as the step runs

    def step_id(self) -> str:
        """Deterministic content-addressed id: the step's name plus the
        structural hash of its inputs — stable across resumes."""
        cached = getattr(self, "_sid", None)
        if cached is not None:
            return cached

        def feed(h, v):
            # recurse through containers so NESTED StepNodes contribute
            # their deterministic ids (a raw pickle of the container
            # would vary across resumes and break completed-step skips)
            if isinstance(v, StepNode):
                h.update(v.step_id().encode())
            elif isinstance(v, (list, tuple)):
                h.update(b"[")
                for x in v:
                    feed(h, x)
                h.update(b"]")
            elif isinstance(v, dict):
                h.update(b"{")
                for k in sorted(v, key=repr):
                    h.update(repr(k).encode())
                    feed(h, v[k])
                h.update(b"}")
            else:
                h.update(_stable_bytes(v))

        h = hashlib.sha1(self.name.encode())
        # the FUNCTION is part of the identity: same-named steps with
        # different bodies (or a body edited between run and resume)
        # must not reuse each other's persisted results
        fn = self.fn
        h.update(getattr(fn, "__module__", "").encode())
        h.update(getattr(fn, "__qualname__", "").encode())
        code = getattr(fn, "__code__", None)
        if code is not None:
            h.update(_code_digest(code))
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                h.update(_stable_bytes(cell.cell_contents))
            except ValueError:  # an empty cell
                h.update(b"<empty>")
        for a in self.args:
            feed(h, a)
        for k in sorted(self.kwargs):
            h.update(k.encode())
            feed(h, self.kwargs[k])
        self._sid = f"{self.name}-{h.hexdigest()[:16]}"
        return self._sid


def _code_digest(code: types.CodeType) -> bytes:
    """A digest of a code object's content that is the same in every
    process: marshal's bytes are not (they mark objects by their
    reference counts), nor is the repr of a nested code object (it holds
    its address) or of a frozenset of strings (`x in {"a", "b"}`)."""
    h = hashlib.sha1(code.co_code)
    h.update(repr((code.co_name, code.co_names, code.co_varnames,
                   code.co_freevars, code.co_cellvars)).encode())
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            h.update(_code_digest(c))
        elif isinstance(c, frozenset):  # its order follows str hashing
            h.update(repr(sorted(map(repr, c))).encode())
        else:
            h.update(repr(c).encode())
    return h.digest()


class _HashPickler(ser.Pickler):
    """The port's by-value pickler with each code object written as its
    `_code_digest`: bytes to hash, never to load."""

    def _function_reduce(self, fn):
        rv = super()._function_reduce(fn)
        return (rv[0], (_code_digest(fn.__code__),) + rv[1][1:]) + rv[2:]


def _stable_bytes(v) -> bytes:
    """Bytes of a step input for its id: the port's by-value pickle with
    code written by content, or its repr when it does not pickle."""
    f = io.BytesIO()
    try:
        _HashPickler(f, protocol=5).dump(v)
    except Exception:  # noqa: BLE001
        return repr(v).encode()
    return f.getvalue()


class _StepFunction:
    def __init__(self, fn, name=None, max_retries=0, num_cpus=1.0,
                 timeout_s=None):
        self._fn = fn
        self._name = name or fn.__name__
        self._max_retries = max_retries
        self._num_cpus = num_cpus
        self._timeout_s = timeout_s

    def step(self, *args, **kwargs) -> StepNode:
        return StepNode(self._fn, self._name, args, kwargs,
                        self._max_retries, self._num_cpus,
                        self._timeout_s)

    def options(self, **kw) -> "_StepFunction":
        return _StepFunction(self._fn, kw.get("name", self._name),
                             kw.get("max_retries", self._max_retries),
                             kw.get("num_cpus", self._num_cpus),
                             kw.get("timeout_s", self._timeout_s))

    def __call__(self, *a, **kw):
        return self._fn(*a, **kw)


def step(_fn=None, *, name: str | None = None, max_retries: int = 0,
         num_cpus: float = 1.0, timeout_s: float | None = None):
    """Decorator: make a function a workflow step (reference:
    workflow step API). `timeout_s` bounds ONE execution of the step;
    the default (None) waits as long as the step runs — durable DAGs
    exist precisely for long jobs."""

    def wrap(fn):
        return _StepFunction(fn, name, max_retries, num_cpus, timeout_s)

    return wrap(_fn) if _fn is not None else wrap


# ------------------------------------------------------------ storage


class _Storage:
    def __init__(self, root: str, workflow_id: str):
        self.dir = os.path.join(root, workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)

    def write_status(self, status: str, error: str | None = None):
        tmp = os.path.join(self.dir, ".status.tmp")
        with open(tmp, "w") as f:
            json.dump({"status": status, "error": error,
                       "time": time.time()}, f)
        os.replace(tmp, os.path.join(self.dir, "status.json"))

    def read_status(self) -> dict:
        try:
            with open(os.path.join(self.dir, "status.json")) as f:
                return json.load(f)
        except OSError:
            return {"status": "NOT_FOUND"}

    def save_dag(self, node: StepNode):
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            f.write(ser.dumps_fn(node))

    def load_dag(self) -> StepNode:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return ser.loads_fn(f.read())

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(os.path.join(self.steps_dir,
                                           step_id + ".pkl"))

    def save_step(self, step_id: str, value: Any):
        tmp = os.path.join(self.steps_dir, step_id + ".tmp")
        with open(tmp, "wb") as f:
            f.write(ser.dumps_fn(value))  # durable BEFORE marked done
        os.replace(tmp, os.path.join(self.steps_dir, step_id + ".pkl"))

    def load_step(self, step_id: str) -> Any:
        with open(os.path.join(self.steps_dir, step_id + ".pkl"),
                  "rb") as f:
            return ser.loads_fn(f.read())


# ------------------------------------------------------------ executor


def _execute(node: StepNode, storage: _Storage, stats: dict) -> Any:
    """Post-order DAG walk: resolve inputs (recursively), skip steps
    whose results are persisted, run the rest as ray_tpu_torch tasks
    (reference: workflow_executor.py — the executor resolves
    WorkflowRefs then submits the step as a task)."""
    sid = node.step_id()
    if storage.has_step(sid):
        stats["skipped"] += 1
        return storage.load_step(sid)

    def resolve(v):
        # containers may nest StepNodes (e.g. fan-in via a list of
        # steps) — resolve recursively, mirroring step_id's hashing
        if isinstance(v, StepNode):
            return _execute(v, storage, stats)
        if isinstance(v, list):
            return [resolve(x) for x in v]
        if isinstance(v, tuple):
            return tuple(resolve(x) for x in v)
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        return v

    args = tuple(resolve(a) for a in node.args)
    kwargs = {k: resolve(v) for k, v in node.kwargs.items()}

    import ray_tpu_torch as ray

    task = ray.remote(num_cpus=node.num_cpus,
                      max_retries=node.max_retries)(node.fn)
    value = ray.get(task.remote(*args, **kwargs), timeout=node.timeout_s)
    storage.save_step(sid, value)
    stats["executed"] += 1
    return value


def run(node: StepNode, *, workflow_id: str | None = None,
        storage: str | None = None) -> Any:
    """Execute a workflow DAG durably; returns the final step's value.
    Reference: workflow.run (api.py)."""
    if not isinstance(node, StepNode):
        raise WorkflowError("workflow.run expects a StepNode "
                            "(build one with @workflow.step + .step(...))")
    workflow_id = workflow_id or f"wf-{int(time.time())}-{os.getpid()}"
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    st.save_dag(node)
    st.write_status(RUNNING)
    stats = {"executed": 0, "skipped": 0}
    try:
        value = _execute(node, st, stats)
    except BaseException as e:
        st.write_status(FAILED, error=repr(e))
        raise
    st.save_step("__result__", value)
    st.write_status(SUCCESS)
    return value


def resume(workflow_id: str, *, storage: str | None = None) -> Any:
    """Re-run a workflow from its logged DAG; completed steps are
    skipped via their durable results (reference: workflow.resume)."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    status = st.read_status()
    if status["status"] == "NOT_FOUND":
        raise WorkflowError(f"no workflow {workflow_id!r}")
    if status["status"] == SUCCESS:
        return st.load_step("__result__")
    node = st.load_dag()
    st.write_status(RUNNING)
    stats = {"executed": 0, "skipped": 0}
    try:
        value = _execute(node, st, stats)
    except BaseException as e:
        st.write_status(FAILED, error=repr(e))
        raise
    st.save_step("__result__", value)
    st.write_status(SUCCESS)
    return value


def get_status(workflow_id: str, *, storage: str | None = None) -> str:
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    s = st.read_status()["status"]
    # a workflow last seen RUNNING whose driver is gone is resumable
    return RESUMABLE if s in (RUNNING, FAILED) else s


def list_all(*, storage: str | None = None) -> list[tuple[str, str]]:
    root = storage or _DEFAULT_STORAGE
    out = []
    try:
        ids = sorted(os.listdir(root))
    except OSError:
        return []
    for wid in ids:
        if os.path.isdir(os.path.join(root, wid)):
            out.append((wid, get_status(wid, storage=root)))
    return out


def get_output(workflow_id: str, *, storage: str | None = None) -> Any:
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    if st.read_status()["status"] != SUCCESS:
        raise WorkflowError(f"workflow {workflow_id!r} has no output "
                            f"(status {st.read_status()['status']})")
    return st.load_step("__result__")
