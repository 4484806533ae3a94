"""Streaming executor — resource-managed, backpressured block execution:
the port's copy of ``ray_tpu/data/executor.py``.

Reference parity: the StreamingExecutor + ResourceManager +
backpressure policies (python/ray/data/_internal/execution/
streaming_executor.py:48, execution/resource_manager.py,
backpressure_policy.py:11 ConcurrencyCapBackpressurePolicy). The
executor admits new block tasks only while every policy allows it:
a concurrency cap bounds in-flight tasks, and a memory budget bounds
the BYTES of produced-but-unconsumed blocks (sizes read from the
owner's object metadata after task_done) so ingestion cannot crowd
training out of host RAM.

The default memory budget is a quarter of the object store's
capacity (``core.config`` ``OBJECT_STORE_BYTES``, which
``RAY_TPU_OBJECT_STORE_BYTES`` sets), as in the JAX package. Deviation:
no execution is published to a dashboard view (the dashboard is not
ported). The local runtime keeps no ownership table, so `_ref_size` is
0 and the memory policy reduces to the concurrency cap, as in the JAX
package's local mode.
"""

from __future__ import annotations

from typing import Iterator


class ExecutionStats:
    __slots__ = ("in_flight", "buffered_bytes", "submitted", "yielded",
                 "backpressure_waits", "peak_buffered_bytes")

    def __init__(self):
        self.in_flight = 0
        self.buffered_bytes = 0
        self.submitted = 0
        self.yielded = 0
        self.backpressure_waits = 0
        self.peak_buffered_bytes = 0


class BackpressurePolicy:
    """Admission policy: may a new block task be submitted now?
    (reference: backpressure_policy.py:11)."""

    def can_add_input(self, stats: ExecutionStats) -> bool:
        raise NotImplementedError


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    def __init__(self, cap: int):
        self.cap = max(1, cap)

    def can_add_input(self, stats: ExecutionStats) -> bool:
        return stats.in_flight < self.cap


class MemoryBudgetBackpressurePolicy(BackpressurePolicy):
    """Bounds bytes of completed-but-unconsumed output blocks (the
    ResourceManager's object-store budget role). Always admits when
    nothing is in flight so execution cannot deadlock on one oversized
    block."""

    def __init__(self, budget_bytes: int):
        self.budget = max(1, budget_bytes)

    def can_add_input(self, stats: ExecutionStats) -> bool:
        return (stats.in_flight == 0
                or stats.buffered_bytes < self.budget)


def default_policies(max_in_flight: int | None = None,
                     memory_budget: int | None = None):
    import ray_tpu_torch
    from ray_tpu_torch.core import config as cfg

    cap = max_in_flight or max(
        2, int(ray_tpu_torch.cluster_resources().get("CPU", 4)))
    budget = memory_budget or cfg.get("OBJECT_STORE_BYTES") // 4
    return [ConcurrencyCapBackpressurePolicy(cap),
            MemoryBudgetBackpressurePolicy(budget)]


def _ref_size(ref) -> int:
    """Serialized size of a completed driver-owned output (0 while
    pending/unknown) from the ownership table."""
    from ray_tpu_torch.core.api import _global_runtime

    rt = _global_runtime()
    owned = getattr(rt, "_owned", None)
    if owned is None:
        # local-mode runtime has no ownership table: sizes unknown, the
        # memory policy degrades to the pure concurrency cap
        return 0
    st = owned.get(ref.id.binary())
    if st is not None and st.event.is_set():
        return int(st.size or 0)
    return 0


class StreamingExecutor:
    """Order-preserving streamed map of `submit(block_ref) -> ref` over
    input refs, gated by the policies. The consumer's iteration drives
    admission: blocks buffered ahead of the consumer count against the
    memory budget until yielded."""

    def __init__(self, policies=None):
        self.policies = policies
        self.stats = ExecutionStats()

    def run(self, input_refs, submit) -> Iterator:
        """`input_refs` may be a list, a lazy iterator, or an object
        with `poll(timeout) -> ("item", ref) | ("pending", None) |
        ("end", None)` (streaming read sources produce block refs
        incrementally via ObjectRefGenerator — reference: streaming read
        tasks feed the executor as blocks appear, not after the read
        completes). Polling keeps completed window results flowing to
        the consumer while the next input block is still being read."""
        import time as _t

        import ray_tpu_torch

        policies = self.policies or default_policies()
        stats = self.stats
        window: list = []  # submitted, not yet yielded (input order)
        poll = getattr(input_refs, "poll", None)
        it = iter(input_refs) if poll is None else None
        exhausted = False
        while not exhausted or window:
            # account completed-but-unconsumed bytes
            stats.buffered_bytes = sum(_ref_size(r) for r in window)
            stats.peak_buffered_bytes = max(stats.peak_buffered_bytes,
                                            stats.buffered_bytes)
            done = [r for r in window if _ref_size(r) > 0]
            stats.in_flight = len(window) - len(done)
            if not exhausted:
                if all(p.can_add_input(stats) for p in policies):
                    if poll is not None:
                        kind, ref = poll(0.25)
                        if kind == "item":
                            window.append(submit(ref))
                            stats.submitted += 1
                            continue
                        if kind == "end":
                            exhausted = True
                            continue
                        # pending: fall through and drain the window
                    else:
                        try:
                            nxt = next(it)
                        except StopIteration:
                            exhausted = True
                        else:
                            window.append(submit(nxt))
                            stats.submitted += 1
                        continue
                else:
                    stats.backpressure_waits += 1  # admission deferred
            if window:
                head = window[0]
                ready, _ = ray_tpu_torch.wait([head], num_returns=1,
                                              timeout=0.5)
                if ready:
                    window.pop(0)
                    stats.yielded += 1
                    yield head
                    continue
                _t.sleep(0.01)
            else:
                _t.sleep(0.005)
