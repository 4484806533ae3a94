"""Dataset — lazy plan + streaming execution over the task runtime: the
port's copy of ``ray_tpu/data/dataset.py``, on the port's runtime (in
local mode, `ray_tpu_torch.init(local_mode=True)`: tasks and actors on
threads of this process, blocks passed by reference).

Reference parity: ray.data (python/ray/data/dataset.py:147): a Dataset
is a lazy chain of operators over blocks; execution streams blocks
through remote tasks with bounded in-flight work (the StreamingExecutor
role, data/_internal/execution/streaming_executor.py:48), fusing
consecutive map-like operators into one task per block the way the
physical planner does. `compute="actors"` runs map_batches on a reusable
actor pool (actor_pool_map_operator.py) for stateful/expensive-setup
UDFs.

Deviations from the JAX package: `iter_jax_batches` becomes
`iter_torch_batches`, which hands out torch tensors (DTensors on a mesh)
and keeps numpy's dtypes (int64 and float64 columns stay 64-bit, where
JAX without x64 makes 32-bit arrays). pyarrow is imported only where
parquet or `batch_format="pyarrow"` is used.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from ray_tpu_torch.data.block import (
    batch_to_rows,
    rows_to_batch,
    split_blocks,
)

from ray_tpu_torch.data.plan import (
    FilterRows,
    FlatMapRows,
    Limit,
    LogicalOperator,
    LogicalPlan,
    MapBatches as _MapBatchesOp,
    MapRows,
    Read as _ReadOp,
)

_DEFAULT_PARALLELISM = 8


def _fuse(ops: list[LogicalOperator]) -> Callable[[list], list]:
    """Optimized physical form of the operator chain (rule-based: limit
    pushdown, limit collapse, map fusion — see data/plan.py)."""
    return LogicalPlan(list(ops)).compile()


def _read_stream_impl(thunk):
    yield from thunk()


_READ_STREAM = None


def _read_stream_remote():
    """Module-level streaming read task (ONE stable function object, so
    the runtime's identity-keyed export cache ships it once per
    process, not once per iteration)."""
    global _READ_STREAM
    if _READ_STREAM is None:
        import ray_tpu_torch

        _READ_STREAM = ray_tpu_torch.remote(num_cpus=1)(_read_stream_impl)
    return _READ_STREAM


class _StreamingInput:
    """Pollable block-ref source over streaming read tasks, drained in
    task order (producers all run concurrently; items buffer at the
    owner). The StreamingExecutor polls so already-transformed blocks
    keep flowing while the next read block is still being produced."""

    def __init__(self, gens):
        self._gens = gens
        self._i = 0

    def poll(self, timeout: float):
        from ray_tpu_torch.core import exceptions as _exc

        while self._i < len(self._gens):
            try:
                return ("item", self._gens[self._i]._next_sync(timeout))
            except StopIteration:
                self._i += 1
                continue
            except _exc.GetTimeoutError:
                return ("pending", None)
        return ("end", None)

    def __iter__(self):
        while True:
            kind, ref = self.poll(30.0)
            if kind == "end":
                return
            if kind == "item":
                yield ref


class Dataset:
    def __init__(self, block_refs: list,
                 ops: list[LogicalOperator] | None = None,
                 stream_thunks: list | None = None):
        self._block_refs = block_refs  # ObjectRefs of input blocks
        self._ops = ops or []
        # streaming read source: generator thunks run as
        # num_returns="streaming" tasks; block refs materialize DURING
        # iteration (read_datasource(streaming=True))
        self._stream_thunks = stream_thunks

    def _input_blocks(self):
        """Input block refs: the eager list, or a pollable source pulling
        from streaming read tasks as the producers yield blocks."""
        if self._stream_thunks is None:
            return list(self._block_refs)
        gens = [_read_stream_remote().options(
            num_returns="streaming").remote(t)
            for t in self._stream_thunks]
        return _StreamingInput(gens)

    def _is_plain_stream(self) -> bool:
        """No side stages outside the op list (actor map stage or
        streaming source) — the parts an op-chain consumer can't see."""
        return self._stream_thunks is None and \
            getattr(self, "_actor_stage", None) is None

    def _is_plain_blocks(self) -> bool:
        """True when _block_refs already IS the dataset: no pending
        ops, no actor map stage, no streaming source."""
        return not self._ops and self._is_plain_stream()

    def _require_eager(self, what: str):
        if self._stream_thunks is not None:
            raise ValueError(
                f"{what} needs a known block list; call materialize() on "
                f"this streaming dataset first")

    # ------------------------------------------------------------ create

    @staticmethod
    def from_items(items: Iterable, parallelism: int = _DEFAULT_PARALLELISM
                   ) -> "Dataset":
        """Eager in-memory blocks (items are already resident in the
        driver). For deferred materialization of generated data use
        read_datasource(ItemsDatasource(...)) — same seam as range()."""
        import ray_tpu_torch

        blocks = split_blocks(items, parallelism)
        return Dataset([ray_tpu_torch.put(b) for b in blocks])

    @staticmethod
    def range(n: int, parallelism: int = _DEFAULT_PARALLELISM) -> "Dataset":
        """Lazy integer range THROUGH the datasource seam: blocks
        materialize inside read tasks, never on the driver (reference:
        ray.data.range is a Datasource read)."""
        from ray_tpu_torch.data.datasource import RangeDatasource

        return read_datasource(RangeDatasource(n), parallelism=parallelism)

    # ------------------------------------------------------------ transforms

    def _with(self, op: LogicalOperator) -> "Dataset":
        return Dataset(self._block_refs, self._ops + [op],
                       stream_thunks=self._stream_thunks)

    def map(self, fn: Callable) -> "Dataset":
        return self._with(MapRows(fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with(FilterRows(fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with(FlatMapRows(fn))

    def limit(self, n: int) -> "Dataset":
        """GLOBAL row cap (reference: Dataset.limit). As a plan suffix
        (possibly under 1:1 maps, which the optimizer pushes it past)
        the consuming iterator stops the stream at n rows; when a
        non-1:1 operator FOLLOWS the limit, execution materializes the
        capped rows first (`_split_at_mid_limit`) so downstream sees
        exactly n rows, not n per block."""
        return self._with(Limit(n))

    def _split_at_mid_limit(self) -> "Dataset | None":
        """If the plan has a Limit followed by any non-1:1 operator,
        return an equivalent dataset with everything up to (and incl.)
        that limit MATERIALIZED — per-block limiting alone would leak
        n rows per block into the downstream operator."""
        last = None
        for i, op in enumerate(self._ops):
            if isinstance(op, Limit) and any(
                    not o.one_to_one and not isinstance(o, Limit)
                    for o in self._ops[i + 1:]):
                last = i
        if last is None:
            return None
        prefix = Dataset(self._block_refs, self._ops[:last + 1],
                         stream_thunks=self._stream_thunks)
        rows = prefix.take_all()  # iterator cap enforces the global n
        out = Dataset.from_items(rows, max(1, len(self._block_refs)))
        return Dataset(out._block_refs, self._ops[last + 1:])

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    compute: str | None = None, num_actors: int = 2
                    ) -> "Dataset":
        def apply(block: list) -> list:
            from ray_tpu_torch.data.block import (
                block_num_rows,
                is_columnar,
                to_batch,
                to_rows,
            )

            if not block_num_rows(block):
                return block
            if batch_format == "numpy":
                # columnar in, columnar out: a dict-of-numpy (or bare
                # ndarray) result STAYS columnar — the block moves
                # through the store with out-of-band buffers and the
                # next numpy stage consumes it without row conversion
                # (reference: Arrow blocks flowing between map stages)
                out = fn(to_batch(block))
                if is_columnar(out):
                    return out
                return batch_to_rows(out) if isinstance(out, dict) \
                    else list(out)
            if batch_format == "pyarrow":
                import pyarrow as pa

                rows = [r if isinstance(r, dict) else {"value": r}
                        for r in to_rows(block)]
                out = fn(pa.Table.from_pylist(rows))
                return out.to_pylist()
            out = fn(to_rows(block))
            return list(out)

        if compute == "actors":
            ds = Dataset(self._block_refs, self._ops,
                         stream_thunks=self._stream_thunks)
            ds._actor_stage = (apply, num_actors)  # type: ignore[attr-defined]
            return ds
        return self._with(_MapBatchesOp(apply))

    def repartition(self, num_blocks: int) -> "Dataset":
        """Rebalance into `num_blocks` blocks (reference:
        Dataset.repartition). Columnar outputs stay columnar — the
        blocks are concatenated and re-split as column views, never as
        rows."""
        import ray_tpu_torch

        from ray_tpu_torch.data.block import (
            columnar_kinds_compatible,
            concat_batches,
            is_columnar,
            split_columnar,
        )

        blocks = list(self._iter_output_blocks())
        if blocks and all(is_columnar(b) for b in blocks) and \
                columnar_kinds_compatible(blocks):
            whole = concat_batches(blocks)
            return Dataset([ray_tpu_torch.put(b)
                            for b in split_columnar(whole, num_blocks)])
        rows = [r for b in blocks for r in _to_rows(b)]
        return Dataset.from_items(rows, num_blocks)

    def join(self, other: "Dataset", on: str, how: str = "inner",
             num_blocks: int | None = None) -> "Dataset":
        """Hash join on a key column (reference: Dataset.join — hash
        shuffle co-partitioning both sides, then per-partition probe).
        `how`: "inner" or "left"; right-side duplicate columns get a
        "_1" suffix."""
        if how not in ("inner", "left"):
            raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
        from ray_tpu_torch.data.exchange import join_exchange

        lrefs, lops = self._exchange_input()
        rrefs, rops = other._exchange_input()
        refs = join_exchange(lrefs, _fuse(lops), rrefs, _fuse(rops),
                             self._out_partitions(num_blocks), on, how)
        return Dataset(refs)

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets block-wise (reference: Dataset.union —
        no driver materialization of rows; pending plans execute into
        blocks first)."""
        refs = []
        for ds in (self, *others):
            if not ds._is_plain_blocks():
                ds = ds.materialize()
            refs.extend(ds._block_refs)
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        """Merge two datasets column-wise, row for row (reference:
        Dataset.zip — equal row counts required; duplicate column names
        from the right side get a "_1" suffix; non-dict rows pair into
        tuples). Runs as one remote zip task per left block, with the
        right side re-sliced to align — columnar blocks merge as column
        dicts without row conversion."""
        import ray_tpu_torch

        left = self if self._is_plain_blocks() else self.materialize()
        right = other if other._is_plain_blocks() else other.materialize()

        @ray_tpu_torch.remote(num_cpus=1)
        def _nrows(b):
            from ray_tpu_torch.data.block import block_num_rows

            return block_num_rows(b)

        lc = ray_tpu_torch.get(
            [_nrows.remote(r) for r in left._block_refs], timeout=600)
        rc = ray_tpu_torch.get(
            [_nrows.remote(r) for r in right._block_refs], timeout=600)
        if sum(lc) != sum(rc):
            raise ValueError(
                f"zip: datasets must have equal row counts "
                f"({sum(lc)} vs {sum(rc)})")

        # right-block spans covering each left block's row range
        r_starts = []
        acc = 0
        for c in rc:
            r_starts.append(acc)
            acc += c
        out_refs = []
        pos = 0
        for li, lref in enumerate(left._block_refs):
            lo, hi = pos, pos + lc[li]
            pos = hi
            spans, rrefs = [], []
            for ri, (rs, c) in enumerate(zip(r_starts, rc)):
                re_ = rs + c
                if re_ <= lo or rs >= hi or c == 0:
                    continue
                spans.append((len(rrefs), max(lo, rs) - rs,
                              min(hi, re_) - rs))
                rrefs.append(right._block_refs[ri])
            out_refs.append(ray_tpu_torch.remote(num_cpus=1)(
                _zip_blocks_fn).remote(lref, spans, *rrefs))
        return Dataset(out_refs)

    # ---------------------------------------------------------- all-to-all

    def _out_partitions(self, num_blocks: int | None) -> int:
        return max(1, num_blocks or len(self._block_refs))

    def _exchange_input(self) -> tuple[list, list]:
        """(block_refs, ops) to feed an all-to-all exchange. A plan
        containing a Limit must be materialized first — the exchange's
        map stage is per-block, so a per-block limit would leak n rows
        PER BLOCK into the shuffle instead of n total."""
        if any(isinstance(o, Limit) for o in self._ops) or \
                not self._is_plain_stream():
            rows = self.take_all()
            ds = Dataset.from_items(rows, max(1, len(self._block_refs)))
            return ds._block_refs, []
        return self._block_refs, self._ops

    def random_shuffle(self, *, seed: int | None = None,
                       num_blocks: int | None = None) -> "Dataset":
        """Global row shuffle via a map/partition/reduce exchange
        (reference: Dataset.random_shuffle, data/dataset.py:1374)."""
        from ray_tpu_torch.data.exchange import shuffle_exchange

        refs, ops = self._exchange_input()
        refs = shuffle_exchange(refs, _fuse(ops),
                                self._out_partitions(num_blocks), seed)
        return Dataset(refs)

    def sort(self, key=None, descending: bool = False,
             num_blocks: int | None = None) -> "Dataset":
        """Distributed sample-partitioned sort (reference: Dataset.sort,
        data/dataset.py:2472). `key` is a column name, a callable, or
        None for the row itself."""
        from ray_tpu_torch.data.exchange import sort_exchange

        refs, ops = self._exchange_input()
        refs = sort_exchange(refs, _fuse(ops),
                             self._out_partitions(num_blocks), key,
                             descending)
        ds = Dataset(refs)
        ds._sorted_desc = descending  # type: ignore[attr-defined]
        return ds

    def groupby(self, key) -> "GroupedData":
        """Hash-partitioned groupby (reference: Dataset.groupby,
        data/dataset.py:2099 -> GroupedData)."""
        return GroupedData(self, key)

    def unique(self, key=None) -> list:
        from ray_tpu_torch.data.exchange import groupby_exchange

        refs, ops = self._exchange_input()
        refs = groupby_exchange(refs, _fuse(ops),
                                self._out_partitions(None), key,
                                lambda k, rows: k)
        return [v for r in Dataset(refs).iter_rows() for v in [r]]

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Deterministic block-wise shard (per-host Train ingestion)."""
        self._require_eager("shard()")
        refs = [r for i, r in enumerate(self._block_refs)
                if i % num_shards == index]
        return Dataset(refs or [], list(self._ops))

    def split(self, n: int) -> list["Dataset"]:
        return [self.shard(n, i) for i in builtins.range(n)]

    # ------------------------------------------------------------ execution

    def _execute(self, max_in_flight: int | None = None,
                 memory_budget: int | None = None) -> Iterator:
        """Stream result block refs in input order under the resource-
        managed streaming executor: a concurrency cap on in-flight tasks
        plus a MEMORY budget on produced-but-unconsumed block bytes
        (reference: streaming_executor.py:48 + resource_manager.py +
        backpressure_policy.py:11)."""
        import ray_tpu_torch

        actor_stage = getattr(self, "_actor_stage", None)
        if not self._ops and actor_stage is None:
            yield from self._input_blocks()
            return
        if actor_stage is None:
            split = self._split_at_mid_limit()
            if split is not None:
                yield from split._execute(max_in_flight, memory_budget)
                return
        fused = _fuse(self._ops)
        from ray_tpu_torch.data.executor import (
            StreamingExecutor,
            default_policies,
        )

        if actor_stage is None:
            @ray_tpu_torch.remote(num_cpus=1)
            def _apply_block(block):
                return fused(block)

            executor = StreamingExecutor(default_policies(
                max_in_flight=max_in_flight, memory_budget=memory_budget))
            self._last_executor = executor  # observability / tests
            yield from executor.run(self._input_blocks(),
                                    lambda ref: _apply_block.remote(ref))
            return

        apply_fn, num_actors = actor_stage

        import ray_tpu_torch as rt

        class _PoolWorker:
            def ready(self):
                return True

            def apply(self, block):
                return apply_fn(fused(block))

        cls = rt.remote(num_cpus=1)(_PoolWorker)
        actors = [cls.remote() for _ in builtins.range(num_actors)]
        # wait for the pool to come up with a generous budget: worker
        # spawn under load can exceed the per-call actor-ready timeout,
        # and a half-started pool surfaces as ActorUnavailableError mid-
        # stream (reference: ActorPool waits on ready refs)
        rt.get([a.ready.remote() for a in actors], timeout=180)
        try:
            # same resource-managed executor as the task path: the actor
            # pool must not outrun the consumer's memory budget either
            executor = StreamingExecutor(default_policies(
                max_in_flight=max_in_flight, memory_budget=memory_budget))
            self._last_executor = executor
            counter = iter(builtins.range(1 << 62))

            def submit(ref):
                return actors[next(counter) % num_actors].apply.remote(ref)

            yield from executor.run(self._input_blocks(), submit)
        finally:
            for a in actors:
                try:
                    rt.kill(a)
                except Exception:  # noqa: BLE001
                    pass

    def materialize(self) -> "Dataset":
        import ray_tpu_torch

        if LogicalPlan(self._ops).global_limit() is not None:
            # a suffix limit is a GLOBAL cap enforced by the row
            # iterator; raw _execute blocks would carry n rows per block
            return Dataset.from_items(self.take_all(),
                                      max(1, len(self._block_refs)))
        refs = list(self._execute())
        # re-put to pin materialized blocks under driver ownership
        blocks = ray_tpu_torch.get(refs, timeout=600)
        return Dataset([ray_tpu_torch.put(b) for b in blocks])

    # ------------------------------------------------------------ consume

    def _iter_output_blocks(self) -> Iterator:
        """Executed blocks in their native format (rows or columnar),
        sliced to the plan's global Limit."""
        import ray_tpu_torch

        from ray_tpu_torch.data.block import block_num_rows, slice_block

        # a plan-suffix Limit caps the GLOBAL row count: stop the stream
        # (and its in-flight work) as soon as it is met
        cap = LogicalPlan(self._ops).global_limit()
        n = 0
        for ref in self._execute():
            block = ray_tpu_torch.get(ref, timeout=600)
            rows = block_num_rows(block)
            if cap is not None and n + rows > cap:
                block = slice_block(block, 0, cap - n)
                rows = cap - n
            if rows:
                n += rows
                yield block
            if cap is not None and n >= cap:
                return

    def iter_rows(self) -> Iterator:
        from ray_tpu_torch.data.block import to_rows

        for block in self._iter_output_blocks():
            yield from to_rows(block)

    def explain(self) -> str:
        """The optimized logical plan (reference: Dataset plan repr)."""
        return LogicalPlan(self._ops).optimized().describe()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy") -> Iterator:
        """Re-batch across block boundaries (reference:
        data/_internal/iterator/). The numpy path is COLUMNAR end to
        end: blocks are consumed as dict-of-numpy batches and re-cut by
        slicing/concatenating column arrays — rows are never
        materialized, and a batch fully inside one block is a numpy
        VIEW of the shm-backed columns (zero copy)."""
        if batch_format == "numpy":
            from ray_tpu_torch.data.block import (
                block_num_rows,
                concat_batches,
                slice_block,
                to_batch,
            )

            pieces: list = []
            have = 0
            for block in self._iter_output_blocks():
                batch = to_batch(block)
                start = 0
                n = block_num_rows(batch)
                while n - start >= batch_size - have:
                    take = batch_size - have
                    pieces.append(slice_block(batch, start, start + take))
                    start += take
                    yield concat_batches(pieces)
                    pieces, have = [], 0
                if start < n:
                    pieces.append(slice_block(batch, start, n))
                    have += n - start
            if have:
                yield concat_batches(pieces)
            return

        def fmt(rows):
            if batch_format == "pyarrow":
                import pyarrow as pa

                return pa.Table.from_pylist(
                    [r if isinstance(r, dict) else {"value": r}
                     for r in rows])
            return rows

        buf: list = []
        for row in self.iter_rows():
            buf.append(row)
            if len(buf) >= batch_size:
                yield fmt(buf)
                buf = []
        if buf:
            yield fmt(buf)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           sharding=None, mesh=None,
                           drop_last: bool = True,
                           device=None) -> Iterator:
        """Device-feed iterator (reference: iter_torch_batches,
        data/_internal/iterator/iter_batches.py — host block →
        device-resident training batch). Each fixed-size numpy batch
        becomes torch tensors on `device` (the card unless the caller
        names another), copied from pinned host memory with
        ``non_blocking=True``: the copy is queued on the current stream
        and the next host batch's preparation runs while it is in
        flight (the pinned buffer is held until the copy is done).

        Pass either `sharding` (a `parallel.sharding.NamedSharding`,
        applied to every leaf) or `mesh` (batch dim sharded over the
        mesh's batch axes, the rule of train.spmd.batch_shardings);
        either gives DTensors on the mesh's device, each rank holding
        the global batch and keeping its own rows (no communication).
        `drop_last=True` keeps every yielded batch shape-identical —
        required for a captured or compiled step and for even sharding.
        Columns keep numpy's dtypes (int64 stays int64)."""
        import torch

        from ray_tpu_torch.util import tree

        if sharding is None and mesh is not None:
            from ray_tpu_torch.parallel.mesh import BATCH_AXES, mesh_shape
            from ray_tpu_torch.parallel.sharding import (
                NamedSharding,
                PartitionSpec,
            )

            sizes = mesh_shape(mesh)
            axes = tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)
            sharding = NamedSharding(mesh,
                                     PartitionSpec(axes if axes else None))
        if sharding is not None and not drop_last:
            # a partial last batch's row count need not divide the shard
            # count — distributing it would explode mid-iteration; fail
            # early
            raise ValueError(
                "iter_torch_batches: drop_last=False cannot be combined "
                "with a sharding/mesh (the final partial batch may not "
                "divide evenly across shards)")
        if sharding is not None:
            dt = sharding.mesh.device_type
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dt == "cuda" else torch.device(dt))
        else:
            from ray_tpu_torch.util.device import resolve_device

            dev = resolve_device(device)

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if dev.type == "cpu":
                # a copy, as a device_put is: the block stays untouched
                t = t.clone()
            else:
                t = t.pin_memory().to(dev, non_blocking=True)
            if sharding is None:
                return t
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t, sharding.mesh, sharding.placements,
                                     src_data_rank=None)

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy"):
            leaves = tree.leaves(batch)
            if not leaves:
                continue
            if drop_last and len(leaves[0]) < batch_size:
                continue
            yield tree.tree_map(put, batch)

    def take(self, n: int = 20) -> list:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list:
        return list(self.iter_rows())

    def count(self) -> int:
        import ray_tpu_torch

        from ray_tpu_torch.data.block import block_num_rows

        if self._is_plain_blocks():
            return sum(block_num_rows(b) for b in
                       ray_tpu_torch.get(list(self._block_refs),
                                         timeout=600))
        return sum(1 for _ in self.iter_rows())

    def num_blocks(self) -> int:
        return len(self._block_refs)

    def sum(self) -> Any:
        return sum(self.iter_rows())

    def write_parquet(self, directory: str) -> list[str]:
        """One parquet file per block via Arrow (reference:
        Dataset.write_parquet)."""
        import os as _os

        import pyarrow as pa
        import pyarrow.parquet as pq

        import ray_tpu_torch

        if LogicalPlan(self._ops).global_limit() is not None:
            # enforce the GLOBAL cap before writing (per-block slices
            # would write n rows per block)
            return self.materialize().write_parquet(directory)
        _os.makedirs(directory, exist_ok=True)
        paths = []
        for i, ref in enumerate(self._execute()):
            block = ray_tpu_torch.get(ref, timeout=600)
            path = _os.path.join(directory, f"part-{i:05d}.parquet")
            rows = [r if isinstance(r, dict) else {"value": r}
                    for r in _to_rows(block)]
            pq.write_table(pa.Table.from_pylist(rows), path)
            paths.append(path)
        return paths

    def write_jsonl(self, directory: str) -> list[str]:
        """One output file per block (reference: write_* produce one
        file per block/task)."""
        import json
        import os as _os

        import ray_tpu_torch

        if LogicalPlan(self._ops).global_limit() is not None:
            return self.materialize().write_jsonl(directory)
        _os.makedirs(directory, exist_ok=True)
        paths = []
        for i, ref in enumerate(self._execute()):
            block = ray_tpu_torch.get(ref, timeout=600)
            path = _os.path.join(directory, f"part-{i:05d}.jsonl")
            with open(path, "w") as f:
                for row in _to_rows(block):
                    # numpy values serialize as numbers/lists, not strs
                    f.write(json.dumps(row, default=_json_default) + "\n")
            paths.append(path)
        return paths

    def __repr__(self):
        ops = "->".join(o.name for o in self._ops) or "source"
        return f"Dataset(blocks={len(self._block_refs)}, plan={ops})"


class AggregateFn:
    """A named aggregation over a group's rows (reference:
    ray.data.aggregate.AggregateFn — here list-at-once instead of
    accumulate/merge, proportionate to block-resident groups)."""

    def __init__(self, name: str, fn: Callable[[list], Any]):
        self.name = name
        self.fn = fn


def Count() -> AggregateFn:  # noqa: N802 — reference-parity naming
    return AggregateFn("count", len)


def Sum(col=None) -> AggregateFn:  # noqa: N802
    return AggregateFn(f"sum({col})" if col else "sum",
                       lambda rows: sum(_col(rows, col)))


def Mean(col=None) -> AggregateFn:  # noqa: N802
    return AggregateFn(f"mean({col})" if col else "mean",
                       lambda rows: sum(_col(rows, col)) / len(rows))


def Min(col=None) -> AggregateFn:  # noqa: N802
    return AggregateFn(f"min({col})" if col else "min",
                       lambda rows: min(_col(rows, col)))


def Max(col=None) -> AggregateFn:  # noqa: N802
    return AggregateFn(f"max({col})" if col else "max",
                       lambda rows: max(_col(rows, col)))


def Std(col=None) -> AggregateFn:  # noqa: N802
    def std(rows):
        vals = list(_col(rows, col))
        m = sum(vals) / len(vals)
        return (sum((v - m) ** 2 for v in vals) / max(1, len(vals) - 1)) ** 0.5

    return AggregateFn(f"std({col})" if col else "std", std)


def _col(rows, col):
    return (r[col] for r in rows) if col is not None else rows


class GroupedData:
    """Reference parity: ray.data.grouped_data.GroupedData — the result
    of Dataset.groupby; aggregations run as the reduce side of a hash
    exchange."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def _exchange(self, group_reducer) -> Dataset:
        from ray_tpu_torch.data.exchange import groupby_exchange

        refs, ops = self._ds._exchange_input()
        refs = groupby_exchange(
            refs, _fuse(ops),
            self._ds._out_partitions(None), self._key, group_reducer)
        return Dataset(refs)

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        key_name = self._key if isinstance(self._key, str) else "key"
        names = [a.name for a in aggs]
        fns = [a.fn for a in aggs]

        def reduce_group(k, rows):
            out = {key_name: k}
            for name, fn in zip(names, fns):
                out[name] = fn(rows)
            return out

        return self._exchange(reduce_group)

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, col=None) -> Dataset:
        return self.aggregate(Sum(col))

    def mean(self, col=None) -> Dataset:
        return self.aggregate(Mean(col))

    def min(self, col=None) -> Dataset:
        return self.aggregate(Min(col))

    def max(self, col=None) -> Dataset:
        return self.aggregate(Max(col))

    def std(self, col=None) -> Dataset:
        return self.aggregate(Std(col))

    def map_groups(self, fn: Callable[[list], Any]) -> Dataset:
        """fn(rows_of_one_group) -> output row(s); lists are flattened
        (reference: GroupedData.map_groups)."""
        ds = self._exchange(lambda k, rows: fn(rows))
        return ds.flat_map(lambda r: r if isinstance(r, list) else [r])


def _to_rows(block):
    from ray_tpu_torch.data.block import to_rows

    return to_rows(block)


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "item"):
        try:
            return o.item()  # numpy scalar
        except ValueError:
            pass
    return str(o)


def _zip_blocks_fn(lb, spans, *rbs):
    """Zip one left block with the right-side slices covering its row
    range. Columnar x columnar merges column dicts; otherwise rows pair
    into merged dicts / tuples."""
    from ray_tpu_torch.data.block import (
        concat_batches,
        is_columnar,
        slice_block,
        to_rows,
    )

    pieces = [slice_block(rbs[i], s, e) for i, s, e in spans]
    if is_columnar(lb) and isinstance(lb, dict) and pieces and \
            all(isinstance(p, dict) and is_columnar(p) for p in pieces):
        rbat = concat_batches(pieces)
        out = dict(lb)
        for k, v in rbat.items():
            out[k if k not in out else k + "_1"] = v
        return out
    lr = to_rows(lb)
    rr = [r for p in pieces for r in to_rows(p)]
    out = []
    for a, b in zip(lr, rr):
        if isinstance(a, dict) and isinstance(b, dict):
            m = dict(a)
            for k, v in b.items():
                m[k if k not in m else k + "_1"] = v
            out.append(m)
        else:
            out.append((a, b))
    return out


def from_items(items, parallelism: int = _DEFAULT_PARALLELISM) -> Dataset:
    return Dataset.from_items(items, parallelism)


def range(n: int, parallelism: int = _DEFAULT_PARALLELISM) -> Dataset:  # noqa: A001
    return Dataset.range(n, parallelism)


def from_numpy(arr, parallelism: int = _DEFAULT_PARALLELISM) -> Dataset:
    """Columnar blocks straight from ndarray(s) — a dict maps column
    names to arrays (reference: from_numpy building Arrow blocks). The
    splits are views, and the local runtime keeps them by reference, so
    neither split nor store pays a row conversion."""
    import ray_tpu_torch

    from ray_tpu_torch.data.block import split_columnar

    if not isinstance(arr, (dict, np.ndarray)):
        arr = np.asarray(arr)
    return Dataset([ray_tpu_torch.put(b)
                    for b in split_columnar(arr, parallelism)])


def read_datasource(datasource, *,
                    parallelism: int = _DEFAULT_PARALLELISM,
                    streaming: bool = False) -> Dataset:
    """Lazy Dataset over any Datasource (reference:
    ray.data.read_datasource; data/datasource/datasource.py contract).
    Each ReadTask materializes its block INSIDE a remote task — the
    driver only ships the thunks.

    With streaming=True, the read runs as num_returns="streaming" tasks
    over `get_block_streams`: each producer yields blocks incrementally
    (e.g. one per file in a group) and downstream consumes block 0 while
    block k is still being read (reference: streaming read tasks under
    ray.data's streaming execution)."""
    import ray_tpu_torch

    if streaming:
        thunks = datasource.get_block_streams(parallelism)
        if not thunks:
            raise ValueError(f"{datasource.name} produced no block streams")
        return Dataset([], stream_thunks=thunks)
    tasks = datasource.get_read_tasks(parallelism)
    if not tasks:
        raise ValueError(f"{datasource.name} produced no read tasks")
    refs = [ray_tpu_torch.put([t]) for t in tasks]
    return Dataset(refs, [_ReadOp(lambda block: block[0]())])


def _read_files(source_cls, paths, parallelism, *args, streaming=False):
    """File read_* share one recipe: default parallelism is ONE task
    per file (the natural split unit — a 1000-file directory must not
    collapse to 8 serial readers); an explicit value groups files."""
    ds = source_cls(paths, *args)
    return read_datasource(
        ds, parallelism=parallelism if parallelism is not None
        else max(1, len(ds.paths)), streaming=streaming)


def read_text(paths, *, parallelism: int | None = None,
              streaming: bool = False) -> Dataset:
    """One row per line (reference: ray.data.read_text). The line
    splitting runs in the native mmap scanner (data/lineio.py ->
    _native/lineio.cc) inside the read task."""
    from ray_tpu_torch.data.datasource import TextDatasource

    return _read_files(TextDatasource, paths, parallelism,
                       streaming=streaming)


def read_csv(paths, *, parallelism: int | None = None,
             streaming: bool = False) -> Dataset:
    """Dict rows from CSV with a header (reference: ray.data.read_csv;
    stdlib csv instead of Arrow)."""
    from ray_tpu_torch.data.datasource import CSVDatasource

    return _read_files(CSVDatasource, paths, parallelism,
                       streaming=streaming)


def read_json(paths, *, parallelism: int | None = None,
              streaming: bool = False) -> Dataset:
    """JSONL rows (reference: ray.data.read_json)."""
    from ray_tpu_torch.data.datasource import JSONLDatasource

    return _read_files(JSONLDatasource, paths, parallelism,
                       streaming=streaming)


def read_parquet(paths, columns: list[str] | None = None, *,
                 parallelism: int | None = None) -> Dataset:
    """Columnar parquet read — one Arrow table per file, read inside
    tasks (reference: ray.data.read_parquet backed by
    data/_internal/arrow_block.py). Rows surface as dicts; use
    map_batches(batch_format="pyarrow") to stay columnar."""
    from ray_tpu_torch.data.datasource import ParquetDatasource

    return _read_files(ParquetDatasource, paths, parallelism, columns)


def from_arrow(table, parallelism: int = _DEFAULT_PARALLELISM) -> Dataset:
    """Dataset from a pyarrow Table (reference: ray.data.from_arrow)."""
    return Dataset.from_items(table.to_pylist(), parallelism)
