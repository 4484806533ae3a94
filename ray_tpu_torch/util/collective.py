"""Out-of-band collectives between named groups of tasks/actors.

The port's copy of ``ray_tpu/util/collective.py``. Reference parity:
python/ray/util/collective/collective.py (GroupManager :40,
init_collective_group :120, allreduce :258, allgather :423,
reducescatter :472, send/recv :531,594, broadcast, barrier) with
NCCL/Gloo backends.

The split: tensors inside one SPMD program use in-program collectives
(ray_tpu_torch.parallel.ops over a mesh's process groups). THIS module
is the host-side path the reference's Gloo backend covers: values held
by N separate actor/task processes. It runs over a rendezvous actor
(per group) through the object store — correct everywhere, used for
metadata barriers, weight broadcast and host reductions.

A leaf of a value may be a numpy array or a torch tensor. Tensor leaves
reduce with torch's add, mul, minimum and maximum (numpy's ufuncs for
numpy leaves); MEAN scales by ``1/len`` either way. A member moves its
CUDA leaves to the host before it offers or sends them, so the
coordinator (a ``num_cpus=0`` actor with no card) never holds a CUDA
tensor, and a result comes back on the device of the caller's own leaf
in the same place of its tree. A rank that passes None (a non-root
rank's `broadcast`) gets the value on the host.

Design notes:
- Group state is keyed by the *calling execution context* (actor id or
  task id), not just the process: in local mode every member shares one
  process, and per-process state made members overwrite each other's
  rank.
- The rendezvous protocol is two-phase and non-blocking on the actor:
  `offer` records a contribution and returns immediately; members then
  `poll` until the round's result is ready. No actor threads are ever
  parked waiting on other members, so progress never depends on the
  coordinator's max_concurrency.
- `offer` is idempotent per (kind, seq, rank): at-least-once RPC
  delivery (submitter retries) cannot corrupt a round.
- Each round is observed in the ``collective_seconds`` histogram and
  recorded as a ``collective.<kind>`` span.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any

import numpy as np


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


def _is_tensor(x) -> bool:
    # torch loads only where a tensor already exists: a coordinator that
    # reduces numpy values never imports it
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


# op name -> (numpy ufunc, torch function name)
_BINOPS = {"add": (np.add, "add"), "mul": (np.multiply, "mul"),
           "min": (np.minimum, "minimum"), "max": (np.maximum, "maximum")}


def _binop(name: str):
    np_op, torch_name = _BINOPS[name]

    def op(a, b):
        if _is_tensor(a):
            return getattr(sys.modules["torch"], torch_name)(a, b)
        return np_op(a, b)

    return op


_REDUCERS = {
    ReduceOp.SUM: lambda arrs: _tree_binop(arrs, _binop("add")),
    ReduceOp.PRODUCT: lambda arrs: _tree_binop(arrs, _binop("mul")),
    ReduceOp.MIN: lambda arrs: _tree_binop(arrs, _binop("min")),
    ReduceOp.MAX: lambda arrs: _tree_binop(arrs, _binop("max")),
    ReduceOp.MEAN: lambda arrs: _tree_scale(_tree_binop(arrs, _binop("add")),
                                            1.0 / len(arrs)),
}


def _tree_binop(arrs, op):
    out = arrs[0]
    for a in arrs[1:]:
        out = _map2(out, a, op)
    return out


def _map2(a, b, op):
    if isinstance(a, dict):
        return {k: _map2(a[k], b[k], op) for k in a}
    if isinstance(a, (list, tuple)):
        t = [_map2(x, y, op) for x, y in zip(a, b)]
        return type(a)(t) if not isinstance(a, tuple) else tuple(t)
    return op(a, b)


def _tree_scale(a, s):
    if isinstance(a, dict):
        return {k: _tree_scale(v, s) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        t = [_tree_scale(x, s) for x in a]
        return tuple(t) if isinstance(a, tuple) else t
    return a * s


def _to_host(tree):
    """`tree` with every tensor leaf that lies on a card copied to the
    host (what a member offers or sends)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_to_host(v) for v in tree)
    if _is_tensor(tree) and tree.device.type != "cpu":
        return tree.detach().cpu()
    return tree


def _like(result, mine):
    """`result` with each tensor leaf moved to the device of the tensor
    in the same place of `mine`, the caller's own value."""
    if isinstance(mine, dict) and isinstance(result, dict):
        return {k: _like(v, mine[k]) if k in mine else v
                for k, v in result.items()}
    if type(mine) in (list, tuple) and type(result) is type(mine):
        return type(result)(_like(r, m) for r, m in zip(result, mine))
    if _is_tensor(mine) and _is_tensor(result) and \
            result.device != mine.device:
        return result.to(mine.device)
    return result


class _Rendezvous:
    """Coordinator actor for one collective group. Rounds are keyed by
    (kind, seq); members pipeline ops freely because every member keeps
    its own monotonically increasing seq."""

    def __init__(self, world_size: int):
        self.world = world_size
        self._lock = threading.Lock()
        self._rounds: dict[tuple, dict] = {}  # (kind, seq) -> round state
        self._done: deque[tuple] = deque(maxlen=1024)  # completed round keys
        self._done_set: set[tuple] = set()
        self._mail: dict[tuple, Any] = {}  # (src, dst, seq) -> payload

    def offer(self, kind: str, seq: int, rank: int, data, op: str | None,
              root: int | None = None) -> bool:
        """Record `rank`'s contribution to round (kind, seq). Returns
        immediately; never blocks on other members."""
        key = (kind, seq)
        with self._lock:
            if key in self._done_set:
                return True  # duplicate delivery of a finished round
            r = self._rounds.get(key)
            if r is None:
                r = self._rounds[key] = {"data": {}, "result": None,
                                         "ready": False, "fetched": 0}
            if rank in r["data"]:
                return True  # duplicate contribution (RPC retry)
            r["data"][rank] = data
            if len(r["data"]) == self.world and not r["ready"]:
                ordered = [r["data"][i] for i in range(self.world)]
                if kind == "allreduce":
                    r["result"] = _REDUCERS[op](ordered)
                elif kind == "allgather":
                    r["result"] = ordered
                elif kind == "broadcast":
                    r["result"] = r["data"][root]
                elif kind == "barrier":
                    r["result"] = True
                elif kind == "reducescatter":
                    r["result"] = _REDUCERS[op](ordered)
                r["ready"] = True
        return True

    def poll(self, kind: str, seq: int):
        """(ready, result). Once every member has fetched, the round is
        retired into the done-set so retried offers stay idempotent."""
        key = (kind, seq)
        with self._lock:
            r = self._rounds.get(key)
            if r is None:
                # either unknown or already retired: treat retired rounds
                # as an error (a member polled twice) — callers poll once.
                return (False, None)
            if not r["ready"]:
                return (False, None)
            result = r["result"]
            r["fetched"] += 1
            if r["fetched"] >= self.world:
                self._rounds.pop(key, None)
                self._done.append(key)
                self._done_set.add(key)
                while len(self._done) >= self._done.maxlen:
                    old = self._done.popleft()
                    self._done_set.discard(old)
            return (True, result)

    def progress(self, kind: str, seq: int) -> int:
        with self._lock:
            r = self._rounds.get((kind, seq))
            return len(r["data"]) if r else -1

    def send(self, src: int, dst: int, seq: int, payload):
        with self._lock:
            self._mail[(src, dst, seq)] = payload
        return True

    def try_recv(self, src: int, dst: int, seq: int):
        with self._lock:
            if (src, dst, seq) in self._mail:
                return (True, self._mail.pop((src, dst, seq)))
        return (False, None)


class _GroupState:
    def __init__(self, name, world_size, rank, coordinator):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self.seq = 0
        self.pt_seq = {}

    def next_seq(self) -> int:
        s = self.seq
        self.seq += 1
        return s


# Keyed by (context key, group name). The context key distinguishes
# members that share one OS process (local mode, threaded actors).
_groups: dict[tuple, _GroupState] = {}
_groups_lock = threading.Lock()


def _ctx_key() -> str:
    import ray_tpu_torch

    try:
        ctx = ray_tpu_torch.get_runtime_context()
    except Exception:
        return "driver"
    if ctx.actor_id is not None:
        return f"a:{ctx.actor_id.hex()}"
    if ctx.task_id is not None:
        return f"t:{ctx.task_id.hex()}"
    return "driver"


def init_collective_group(world_size: int, rank: int,
                          backend: str = "auto",
                          group_name: str = "default"):
    """Join (and lazily create) the named group. Every member must call
    this before using collectives (reference: collective.py:120)."""
    import ray_tpu_torch

    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    coord_cls = ray_tpu_torch.remote(num_cpus=0)(_Rendezvous)
    coord = coord_cls.options(
        name=f"__collective_{group_name}", get_if_exists=True,
        max_concurrency=max(4, world_size)).remote(world_size)
    with _groups_lock:
        _groups[(_ctx_key(), group_name)] = _GroupState(
            group_name, world_size, rank, coord)
    barrier(group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    return (_ctx_key(), group_name) in _groups


def destroy_collective_group(group_name: str = "default"):
    with _groups_lock:
        _groups.pop((_ctx_key(), group_name), None)


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def _get(group_name) -> _GroupState:
    g = _groups.get((_ctx_key(), group_name))
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"task/actor context")
    return g


_coll_hist = None

# Round kinds -> canonical `op=` label values on collective_seconds,
# the in-program collectives' vocabulary (all_gather, reduce_scatter).
_OP_LABELS = {"allgather": "all_gather", "reducescatter": "reduce_scatter"}


def _collective_seconds():
    global _coll_hist
    if _coll_hist is None:
        from ray_tpu_torch.util.metrics import Histogram

        _coll_hist = Histogram(
            "collective_seconds",
            "Host-side collective wall time (offer -> result ready)",
            boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30),
            tag_keys=("op",))
    return _coll_hist


def _sync(g: _GroupState, kind, data, op=None, root=None,
          timeout: float = 120.0):
    import ray_tpu_torch

    t0 = time.perf_counter()
    seq = g.next_seq()
    ray_tpu_torch.get(
        g.coordinator.offer.remote(kind, seq, g.rank, _to_host(data), op,
                                   root), timeout=60)
    deadline = time.monotonic() + timeout
    sleep = 0.001
    while time.monotonic() < deadline:
        ready, result = ray_tpu_torch.get(
            g.coordinator.poll.remote(kind, seq), timeout=60)
        if ready:
            dt = time.perf_counter() - t0
            _collective_seconds().observe(
                dt, tags={"op": _OP_LABELS.get(kind, kind)})
            from ray_tpu_torch.util import tracing

            tracing.record_span(f"collective.{kind}", dt,
                                category="collective")
            return result
        time.sleep(sleep)
        sleep = min(sleep * 2, 0.05)
    arrived = ray_tpu_torch.get(g.coordinator.progress.remote(kind, seq),
                                timeout=60)
    raise TimeoutError(f"collective {kind}#{seq} timed out "
                       f"({arrived}/{g.world_size} arrived)")


def allreduce(tensor, group_name: str = "default", op: str = ReduceOp.SUM):
    return _like(_sync(_get(group_name), "allreduce", tensor, op=op),
                 tensor)


def allreduce_multigpu(tensor_list, group_name="default", op=ReduceOp.SUM):
    return [allreduce(t, group_name, op) for t in tensor_list]


def allgather(tensor, group_name: str = "default") -> list:
    return [_like(r, tensor)
            for r in _sync(_get(group_name), "allgather", tensor)]


def reducescatter(tensor, group_name: str = "default", op: str = ReduceOp.SUM):
    """Each rank gets its 1/world shard (along axis 0) of the reduction:
    numpy's ``array_split`` chunks, which ``torch.tensor_split`` gives
    for a tensor.

    Note: the reduction rides through the coordinator whole (allreduce
    cost); this path is for metadata/host tensors."""
    g = _get(group_name)
    reduced = _sync(g, "reducescatter", tensor, op=op)
    if _is_tensor(reduced):
        shard = sys.modules["torch"].tensor_split(reduced, g.world_size,
                                                  dim=0)[g.rank]
    else:
        shard = np.array_split(reduced, g.world_size, axis=0)[g.rank]
    return _like(shard, tensor)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _get(group_name)
    out = _sync(g, "broadcast", tensor if g.rank == src_rank else None,
                root=src_rank)
    return _like(out, tensor)


def barrier(group_name: str = "default"):
    _sync(_get(group_name), "barrier", None)


def send(tensor, dst_rank: int, group_name: str = "default"):
    import ray_tpu_torch

    g = _get(group_name)
    key = (g.rank, dst_rank)
    seq = g.pt_seq.get(key, 0)
    g.pt_seq[key] = seq + 1
    ray_tpu_torch.get(g.coordinator.send.remote(g.rank, dst_rank, seq,
                                                _to_host(tensor)))


def recv(src_rank: int, group_name: str = "default", timeout: float = 120.0):
    """The value rank `src_rank` sent, on the host (a receiver names no
    device of its own)."""
    import ray_tpu_torch

    g = _get(group_name)
    key = (src_rank, g.rank)
    seq = g.pt_seq.get(key, 0)
    g.pt_seq[key] = seq + 1
    deadline = time.monotonic() + timeout
    sleep = 0.001
    while time.monotonic() < deadline:
        ok, payload = ray_tpu_torch.get(
            g.coordinator.try_recv.remote(src_rank, g.rank, seq), timeout=60)
        if ok:
            return payload
        time.sleep(sleep)
        sleep = min(sleep * 2, 0.05)
    raise TimeoutError(f"recv from {src_rank} (seq {seq}) timed out")
