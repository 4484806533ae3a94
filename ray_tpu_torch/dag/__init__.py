"""Compiled DAGs — channel-backed repeated execution of actor graphs.

The port's copy of ``ray_tpu/dag/__init__.py``. Reference parity:
ray.dag accelerated DAGs (python/ray/dag/compiled_dag_node.py:711 —
`experimental_compile` turns a bound actor-method graph into a resident
pipeline: each actor runs a loop reading input CHANNELS, invoking its
method directly, writing its output channel; `execute()` then costs
one channel write + read instead of per-call task submission). Here the
channels are the native shm SPSC rings
(ray_tpu_torch.experimental.channel) and the per-actor loops are
installed by the worker runtime (dag_start).

Compile once, execute many:

    with InputNode() as inp:
        x = a.step.bind(inp)
        y = b.step.bind(x)
    dag = y.compile()              # experimental_compile() also works
    out = dag.execute(5).get()
    dag.teardown()

The fast-path contract (test-gated in tests/test_torch_compiled_dag.py):

- compile() resolves every actor address ONCE and pre-allocates one
  reusable channel slot (an object-ID-named shm ring) per graph edge;
  steady-state execute() is one channel write, intermediate results
  flow worker→worker through their edge channels, and NO head, nodelet
  or per-call RPC is involved.
- Backpressure is structural: every channel is a bounded ring (a
  producer blocks when its consumer's slots are full) and the driver
  additionally caps in-flight executions at `max_inflight`, so a fast
  producer can never overrun a slow consumer — memory stays bounded
  end to end.
- Errors propagate exactly like the eager `.remote()` chain: a stage's
  exception rides the pipeline as a slot-consuming marker and `get()`
  re-raises the same TaskError the eager path would raise.
- On actor death the DAG falls back to the EAGER path: pending and
  subsequent executions replay through ordinary actor calls (the heal
  plane republishes routing for restartable actors; non-restartable
  actors surface ActorDiedError), and teardown() releases every
  channel slot either way.

Values cross the channels through the port's pickler
(ray_tpu_torch.experimental.channel): a stage that returns a CUDA tensor
hands the next stage a tensor on that stage's card.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

_CHANNEL_CAP = 1 << 20
SLOT_PREFIX = "dagt_"  # the shm names of a compiled graph's channel slots

# dag_executions_total (lazy: keep import-time free of the metrics
# registry; the counter appears on first execute)
_exec_counter = None
_exec_counter_lock = threading.Lock()


def _count_execution(fallback: bool):
    global _exec_counter
    if _exec_counter is None:
        with _exec_counter_lock:
            if _exec_counter is None:
                try:
                    from ray_tpu_torch.util.metrics import Counter

                    _exec_counter = Counter(
                        "dag_executions_total",
                        "compiled-DAG executions, by path "
                        "(compiled|eager_fallback)",
                        tag_keys=("path",))
                except Exception:  # noqa: BLE001
                    return
    try:
        _exec_counter.inc(
            1, {"path": "eager_fallback" if fallback else "compiled"})
    except Exception:  # noqa: BLE001
        pass


class _DagError:
    """Slot-consuming error marker in the result sequence. Carries the
    actual remote exception when it pickled, else a message string."""

    def __init__(self, err):
        self.err = err

    def raise_(self):
        if isinstance(self.err, BaseException):
            raise self.err
        raise RuntimeError(str(self.err))


class DAGNode:
    """Base: a node producing one value per execution."""

    def __init__(self, upstream: list["DAGNode"]):
        self.upstream = upstream

    def compile(self, **kwargs) -> "CompiledDAG":
        """Compile this graph into a resident channel pipeline (see the
        module docstring for the fast-path contract)."""
        return CompiledDAG(self, **kwargs)

    def experimental_compile(self, **kwargs) -> "CompiledDAG":
        return self.compile(**kwargs)

    def _walk(self, seen, order):
        if id(self) in seen:
            return
        seen.add(id(self))
        for u in self.upstream:
            u._walk(seen, order)
        order.append(self)


class InputNode(DAGNode):
    """The driver-fed input (reference: ray.dag.InputNode)."""

    def __init__(self):
        super().__init__([])

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class ClassMethodNode(DAGNode):
    """One bound actor method (reference: dag/class_node.py)."""

    def __init__(self, actor_handle, method_name: str,
                 args: tuple["DAGNode", ...]):
        for a in args:
            if not isinstance(a, DAGNode):
                raise TypeError(
                    "compiled-DAG args must be DAG nodes (InputNode or "
                    "other bound methods); constants go in actor state")
        super().__init__(list(args))
        self.actor_handle = actor_handle
        self.method_name = method_name


class MultiOutputNode(DAGNode):
    """Fan-in terminal: execute() returns a list (reference:
    ray.dag.MultiOutputNode)."""

    def __init__(self, outputs: list[DAGNode]):
        super().__init__(list(outputs))


class CompiledDAGRef:
    """Result handle for one execute() (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: float | None = 60.0) -> Any:
        return self._dag._fetch(self._seq, timeout)


class CompiledDAG:
    def __init__(self, output_node: DAGNode, max_inflight: int = 1024,
                 channel_capacity: int = _CHANNEL_CAP,
                 enable_fallback: bool = True):
        from ray_tpu_torch.core.api import _global_runtime
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.experimental.channel import Channel

        self._rt = _global_runtime()
        order: list[DAGNode] = []
        output_node._walk(set(), order)
        self._order = order
        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) != 1:
            raise ValueError("a compiled DAG needs exactly one InputNode")
        self._multi = isinstance(output_node, MultiOutputNode)
        self._loop_prefix = f"dag_{os.urandom(4).hex()}"
        self._max_inflight = max(1, int(max_inflight))
        self._enable_fallback = enable_fallback
        self._broken = False  # actor died: every path goes eager
        # addresses whose process the liveness probe found gone
        self._gone: set[str] = set()
        # one channel per EDGE — a reusable SLOT named by a pre-allocated
        # object id, so the steady state re-uses N rings instead of
        # minting per-call object ids (reference: shared-memory mutable
        # objects, experimental/channel/shared_memory_channel.py)
        self._channels: list[Channel] = []

        def make_chan():
            # "dagt_", where the JAX package names its slots "dagc_": a
            # count of one package's slots in /dev/shm never sees the
            # other's
            c = Channel(name=SLOT_PREFIX + ObjectID.random().hex()[:20],
                        capacity=channel_capacity, create=True)
            self._channels.append(c)
            return c

        compute_nodes = [n for n in order
                         if isinstance(n, ClassMethodNode)]
        self._compute_nodes = compute_nodes
        terminals = (output_node.upstream if self._multi
                     else [output_node])
        for t in terminals:
            if not isinstance(t, ClassMethodNode):
                raise ValueError("DAG outputs must be bound actor methods")
        self._terminals = terminals
        # input edges the driver writes directly
        self._input_edges: list[Channel] = []
        # per-node in/out channel wiring
        node_out: dict[int, list[Channel]] = {}
        node_ins: dict[int, list[Channel]] = {}
        for n in compute_nodes:
            node_ins[id(n)] = []
            for u in n.upstream:
                c = make_chan()
                node_ins[id(n)].append(c)
                if isinstance(u, InputNode):
                    self._input_edges.append(c)
                else:
                    node_out.setdefault(id(u), []).append(c)
        # terminal outputs flow to the driver through one channel each;
        # a node feeding BOTH another node and the driver fans out below
        self._output_chans: list[Channel] = []
        for t in terminals:
            c = make_chan()
            node_out.setdefault(id(t), []).append(c)
            self._output_chans.append(c)
        # install per-actor loops. Fan-out (one producer, many consumer
        # channels) rides a driver-side pump when needed; the common
        # chain/tree case is pure actor-to-actor.
        self._pumps: list[threading.Thread] = []
        self._stop = threading.Event()
        self._loop_ids: list[tuple[str, str]] = []  # (actor addr, loop_id)
        for i, n in enumerate(compute_nodes):
            outs = node_out.get(id(n), [])
            if len(outs) > 1:
                mid = make_chan()
                self._start_pump(mid, outs)
                primary = mid
            else:
                primary = outs[0]
            addr = self._rt._resolve_actor(n.actor_handle._actor_id.binary())
            loop_id = f"{self._loop_prefix}_{i}"
            self._rt.client.call(addr, "dag_start", {
                "loop_id": loop_id,
                "method": n.method_name,
                "in_channels": [c.name for c in node_ins[id(n)]],
                "out_channel": primary.name,
            }, timeout=30)
            self._loop_ids.append((addr, loop_id))
        if len(self._input_edges) > 1:
            # one driver write fans out to every input consumer
            first = make_chan()
            self._start_pump(first, self._input_edges)
            self._write_chan = first
        else:
            self._write_chan = self._input_edges[0]
        self._seq = 0
        self._fetched = 0  # results drained from the output channels
        self._results: dict[int, Any] = {}
        # inputs of not-yet-fetched executions, retained so an actor
        # death can REPLAY them through the eager path (bounded by
        # max_inflight; popped as their row is assembled)
        self._pending_inputs: dict[int, Any] = {}
        # values already drained from SOME output channels of the row
        # currently being assembled — survives a get() timeout so a
        # partially-drained multi-output row is resumed, never lost
        self._partial: list = []
        self._fetch_lock = threading.Lock()
        # driver-side backpressure: execute() blocks here once
        # max_inflight executions are unfetched
        self._flow = threading.Condition()
        # channel writes leave in seq order (concurrent execute())
        self._write_cond = threading.Condition()
        self._next_write = 0

    def _start_pump(self, src, dsts):
        # the pump forwards serialized bytes: it never rebuilds a value,
        # so a CUDA tensor on a fan-out edge needs no card in the driver
        def pump():
            while not self._stop.is_set():
                try:
                    v = src.get_bytes(timeout=0.5)
                except TimeoutError:
                    continue
                except Exception:  # noqa: BLE001
                    return
                for d in dsts:
                    try:
                        d.put_bytes(v, timeout=60)
                    except Exception:  # noqa: BLE001
                        return

        t = threading.Thread(target=pump, daemon=True, name="dag-pump")
        t.start()
        self._pumps.append(t)

    # ------------------------------------------------------------ public

    def execute(self, value: Any) -> CompiledDAGRef:
        """One pipelined execution: a channel write; results stream back
        in order (reference: CompiledDAG.execute). Blocks once
        max_inflight executions are in the pipe (backpressure: a fast
        submitter cannot overrun the slowest stage's channel slots)."""
        t0 = time.monotonic_ns()
        with self._flow:
            # the cap applies on the eager-fallback path too: retained
            # inputs are the fallback's replay state and must stay as
            # bounded as the channel-resident work they replace
            while self._seq - self._fetched >= self._max_inflight:
                if not self._flow.wait(timeout=60.0) and \
                        self._seq - self._fetched >= self._max_inflight:
                    raise TimeoutError(
                        "compiled DAG backpressured for 60s: "
                        "max_inflight results unfetched")
            seq = self._seq
            self._seq += 1
            self._pending_inputs[seq] = value
        # channel writes are serialized IN SEQ ORDER: two concurrent
        # execute() calls must not land their inputs swapped, or the
        # in-order result rows would resolve against the wrong refs
        with self._write_cond:
            while self._next_write != seq and not self._broken:
                self._write_cond.wait(timeout=1.0)
            if not self._broken:
                try:
                    self._write_chan.put(value, timeout=60)
                except Exception:  # noqa: BLE001
                    # pipeline wedged (channel closed / full forever):
                    # flip to the eager path — the value is retained,
                    # the row gets filled at fetch time
                    self._broken = True
            self._next_write = max(self._next_write, seq + 1)
            self._write_cond.notify_all()
        ref = CompiledDAGRef(self, seq)
        _count_execution(fallback=self._broken)
        self._rt._events.record(
            f"dag.execute:{seq}", "dag", t0,
            trace={"trace_id": f"dag:{self._loop_prefix}:{seq}"})
        return ref

    def _fetch(self, seq: int, timeout):
        """Results arrive strictly in execution order (SPSC channels):
        drain until `seq` has landed. Errors CONSUME their slot like any
        result — raising without recording would desynchronize every
        later execution's sequence number. A drain that stalls past its
        poll slice probes the DAG's actors; a dead actor flips the DAG
        to the eager path and pending executions replay there."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._fetch_lock:
            while seq not in self._results:
                if self._broken:
                    self._fallback_fill()
                    continue
                try:
                    self._drain_row(deadline)
                except _PipelineStalled:
                    self._broken = True  # probe said an actor is dead
                    continue
            out = self._results.pop(seq)
            self._pending_inputs.pop(seq, None)
            if isinstance(out, _DagError):
                out.raise_()
            return out

    def _drain_row(self, deadline):
        """Assemble the next result row from the output channels (called
        under _fetch_lock). Channel pops are destructive, so partially
        drained rows persist in self._partial across timeouts."""
        from ray_tpu_torch.experimental.channel import ChannelClosed

        stalls = 0
        next_probe = 1  # probe backoff: 1, 2, 4, ... slices (cap 16)
        while len(self._partial) < len(self._output_chans):
            c = self._output_chans[len(self._partial)]
            rem = (None if deadline is None
                   else deadline - time.monotonic())
            if rem is not None and rem <= 0:
                raise TimeoutError("compiled DAG result timed out")
            try:
                # short poll slices so a dead mid-chain actor is
                # detected in ~1s instead of blocking the full window
                self._partial.append(
                    c.get(timeout=min(1.0, rem) if rem is not None
                          else 1.0))
                stalls = 0
                next_probe = 1
            except TimeoutError:
                # probe with exponential backoff: a legitimately SLOW
                # stage (30s inference step) must not turn every
                # blocked get into 1 head RPC per second
                stalls += 1
                if self._enable_fallback and stalls >= next_probe:
                    if self._any_actor_dead():
                        raise _PipelineStalled from None
                    next_probe = min(next_probe * 2, 16)
                    stalls = 0
                continue
            except ChannelClosed:
                if self._enable_fallback:
                    raise _PipelineStalled from None
                raise
        outs, self._partial = self._partial, []
        err = next((o["__dag_error__"] for o in outs
                    if isinstance(o, dict) and "__dag_error__" in o),
                   None)
        row = self._fetched
        self._results[row] = (
            _DagError(err) if err is not None
            else (outs if self._multi else outs[0]))
        self._pending_inputs.pop(row, None)
        self._fetched += 1
        with self._flow:
            self._flow.notify_all()

    # ------------------------------------------------------ eager fallback

    def _any_actor_dead(self) -> bool:
        """Pipeline-liveness probe (only runs when a drain stalls —
        never on the steady-state path). An actor that is DEAD is lost;
        so is one that restarted to a NEW address: the replacement
        process has no dag loop, so the compiled pipeline can never
        make progress even though the actor is ALIVE — both flip the
        DAG to the eager path. Each such process's address is kept in
        `_gone`, so `teardown()` sends it no stop call (a call to a dead
        address waits out its whole timeout)."""
        replies = self._rt.client.call_gather(
            [(self._rt.head_address, "get_actor",
              {"actor_id": n.actor_handle._actor_id.binary(),
               "wait": False}) for n in self._compute_nodes],
            timeout=5)
        lost = False
        for r, (compiled_addr, _) in zip(replies, self._loop_ids):
            if r is None:
                return True  # head unreachable: treat as lost
            state = r.get("state")
            # restarted to a new address: the loop went with the process
            if state in ("DEAD", "UNKNOWN") or (
                    state == "ALIVE" and r.get("address") != compiled_addr):
                self._gone.add(compiled_addr)
                lost = True
        return lost

    def _fallback_fill(self):
        """Replay every unfetched execution through the EAGER actor-call
        path, in order (called under _fetch_lock once _broken). The
        partially drained compiled row is discarded — the replay
        recomputes it whole; routing re-resolves through the heal
        plane, so restartable actors serve the replay and dead ones
        surface ActorDiedError exactly like an eager chain would."""
        self._partial = []
        # SNAPSHOT the sequence watermark under _flow: execute() racing
        # this fill advances _seq concurrently, and advancing _fetched
        # past a seq whose row was never filled would hang its fetch
        # forever (the raced execution is covered by the next fill —
        # _fetch re-enters here while its seq has no result)
        with self._flow:
            seq_snap = self._seq
        for s in range(self._fetched, seq_snap):
            if s in self._results:
                continue
            try:
                row = self._eager_once(self._pending_inputs.get(s))
            except BaseException as e:  # noqa: BLE001
                # strip the traceback: its frames hold _eager_once's
                # intermediate ObjectRefs, and an exception retained in
                # _results would pin their refcounts — stranding every
                # oid of the failed replay (TaskError already carries
                # the remote traceback as a string)
                e.__traceback__ = None
                row = _DagError(e)
            self._results[s] = row
            _count_execution(fallback=True)
        self._fetched = max(self._fetched, seq_snap)
        with self._flow:
            self._flow.notify_all()

    def _eager_once(self, value):
        """One execution through ordinary `.remote()` calls — the
        bit-parity reference for the compiled path (and its fallback)."""
        refs: dict[int, Any] = {}
        for n in self._order:
            if isinstance(n, InputNode):
                refs[id(n)] = value
            elif isinstance(n, ClassMethodNode):
                args = [refs[id(u)] for u in n.upstream]
                refs[id(n)] = getattr(
                    n.actor_handle, n.method_name).remote(*args)
        outs = self._rt.get([refs[id(t)] for t in self._terminals],
                            timeout=60)
        return outs if self._multi else outs[0]

    def teardown(self):
        self._stop.set()
        for addr, loop_id in self._loop_ids:
            if addr in self._gone:
                continue
            try:
                self._rt.client.call(addr, "dag_stop",
                                     {"loop_id": loop_id}, timeout=10)
            except Exception:  # noqa: BLE001
                pass
        # driver-side pump threads poll at 0.5s: JOIN them before
        # unmapping the segments (destroying under a reader is a UAF on
        # the mmap'd base — segfault, not an exception)
        for t in self._pumps:
            t.join(timeout=2.0)
        # closing marks the ring closed so any still-blocked worker
        # reader exits cleanly before we unlink the names (their own
        # mappings stay valid until their process detaches)
        for c in self._channels:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        time.sleep(0.1)
        for c in self._channels:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
        self._pending_inputs.clear()


class _PipelineStalled(Exception):
    """Internal: the compiled pipeline cannot make progress (dead actor
    or closed channel); the fetch loop flips to the eager path."""


__all__ = ["ClassMethodNode", "CompiledDAG", "CompiledDAGRef", "DAGNode",
           "InputNode", "MultiOutputNode"]
