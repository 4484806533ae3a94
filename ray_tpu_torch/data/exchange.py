"""All-to-all block exchange: shuffle / sort / groupby: the port's copy
of ``ray_tpu/data/exchange.py``. The seeded shuffle draws from the same
numpy streams, so one seed gives the JAX package's order.

Reference parity: ray.data's all-to-all operators —
`random_shuffle` (python/ray/data/dataset.py:1374), `sort` (:2472) and
`groupby` (:2099), executed as the shuffle pattern in
data/_internal/planner/exchange/ (ShuffleTaskSpec / SortTaskSpec:
map tasks partition each block into P sub-blocks, reduce tasks merge
the p-th sub-block of every map output). Here the exchange rides the
task runtime's multi-return objects: every map task returns P
sub-blocks through the shared-memory object store; reduce tasks take
the p-th output of each map as args — arg locality pulls each reduce
to the node holding most of its inputs.

Sort uses sample-based range partitioning (reference:
SortTaskSpec.sample_boundaries) so output blocks are globally ordered.
"""

from __future__ import annotations

import bisect
import pickle
import zlib
from typing import Any, Callable


def _stable_hash(key) -> int:
    """Process-stable hash for partitioning. Python's hash() is salted
    per process (PYTHONHASHSEED) — map tasks run in different worker
    processes, so salted hashes would scatter one group's rows across
    reduce partitions. Numpy scalars normalize to their Python value so
    columnar-sourced keys co-partition with plain ones (np.int64(3) and
    3 must land in the same bucket)."""
    if type(key) not in (str, bytes, int, float, bool) and \
            hasattr(key, "item"):
        # numpy scalars INCLUDING np.str_/np.bytes_ (their pickle bytes
        # differ from the plain value's, so crc32 would diverge)
        try:
            key = key.item()
        except (ValueError, AttributeError):
            pass
    if isinstance(key, int):
        return key
    return zlib.crc32(pickle.dumps(key, protocol=5))


def exchange(block_refs: list, fused: Callable[[list], list],
             num_partitions: int,
             partitioner: Callable[[list, int], list[list]],
             reducer: Callable[[list[list], int], list]) -> list:
    """Run the two-stage exchange; returns refs of P reduced blocks.

    The partitioner receives (rows, block_index) and the reducer
    (parts, partition_index) so randomized exchanges can derive
    DISTINCT per-task rng streams from one user seed (the reference
    derives per-task seeds the same way; a single shared stream makes
    a seeded shuffle collapse to a tiny subset of permutations)."""
    import ray_tpu_torch

    P = max(1, num_partitions)

    @ray_tpu_torch.remote(num_cpus=1, num_returns=P)
    def _map(idx, block):
        from ray_tpu_torch.data.block import to_rows

        # partitioners are row-oriented; columnar blocks convert here
        parts = partitioner(to_rows(fused(block)), idx)
        return tuple(parts) if P > 1 else parts[0]

    @ray_tpu_torch.remote(num_cpus=1)
    def _reduce(p, *parts):
        return reducer(list(parts), p)

    map_outs = [_map.remote(i, ref) for i, ref in enumerate(block_refs)]
    if P == 1:
        map_outs = [[r] for r in map_outs]
    return [_reduce.remote(p, *[m[p] for m in map_outs]) for p in range(P)]


# ---------------------------------------------------------------- shuffle

def shuffle_exchange(block_refs, fused, num_partitions, seed=None):
    import numpy as _np

    # namespaced per-task streams: mappers draw from [seed, 0, idx] and
    # reducers from [seed, 1, p] so the two families can never collide
    # (with [seed, idx] vs [seed, P+p], block idx == P+p reused a stream)
    def partitioner(rows, idx):
        rng = _np.random.default_rng(
            None if seed is None else [seed, 0, idx])
        buckets: list[list] = [[] for _ in range(num_partitions)]
        if rows:
            for row, b in zip(rows, rng.integers(0, num_partitions,
                                                 len(rows))):
                buckets[int(b)].append(row)
        return buckets

    def reducer(parts, p):
        rows = [r for part in parts for r in part]
        rng = _np.random.default_rng(
            None if seed is None else [seed, 1, p])
        rng.shuffle(rows)
        return rows

    return exchange(block_refs, fused, num_partitions, partitioner, reducer)


# ---------------------------------------------------------------- sort

def _key_fn(key) -> Callable[[Any], Any]:
    if key is None:
        return lambda r: r
    if callable(key):
        return key
    return lambda r: r[key]


def sort_exchange(block_refs, fused, num_partitions, key=None,
                  descending=False):
    """Range-partitioned sort: sample keys -> boundaries -> partition ->
    per-partition local sort. Emitting partitions in boundary order makes
    the concatenation globally sorted."""
    import ray_tpu_torch

    kf = _key_fn(key)

    @ray_tpu_torch.remote(num_cpus=1)
    def _sample(block):
        rows = fused(block)
        step = max(1, len(rows) // 64)
        return [kf(r) for r in rows[::step]]

    samples = sorted(
        s for out in ray_tpu_torch.get(
            [_sample.remote(r) for r in block_refs], timeout=600)
        for s in out)
    P = max(1, min(num_partitions, len(samples) or 1))
    boundaries = [samples[int(len(samples) * (i + 1) / P)]
                  for i in range(P - 1)] if samples else []

    def partitioner(rows, _idx):
        buckets: list[list] = [[] for _ in range(P)]
        for r in rows:
            buckets[bisect.bisect_right(boundaries, kf(r))].append(r)
        return buckets

    def reducer(parts, _p):
        rows = [r for part in parts for r in part]
        rows.sort(key=kf, reverse=descending)
        return rows

    refs = exchange(block_refs, fused, P, partitioner, reducer)
    return list(reversed(refs)) if descending else refs


# ---------------------------------------------------------------- groupby

def groupby_exchange(block_refs, fused, num_partitions, key,
                     group_reducer: Callable[[Any, list], Any]):
    """Hash-partition rows by key; apply `group_reducer(key, rows)` to
    each group. Output rows ordered by key within each block."""
    kf = _key_fn(key)

    def partitioner(rows, _idx):
        buckets: list[list] = [[] for _ in range(num_partitions)]
        for r in rows:
            buckets[_stable_hash(kf(r)) % num_partitions].append(r)
        return buckets

    def reducer(parts, _p):
        groups: dict = {}
        for part in parts:
            for r in part:
                groups.setdefault(kf(r), []).append(r)
        return [group_reducer(k, rows)
                for k, rows in sorted(groups.items(), key=lambda kv: kv[0])]

    return exchange(block_refs, fused, num_partitions, partitioner, reducer)


# ------------------------------------------------------------------ join


def join_exchange(left_refs, left_fused, right_refs, right_fused,
                  num_partitions: int, on: str, how: str = "inner"):
    """Hash join: both sides co-partition rows by key hash, one reduce
    task per partition builds a hash table on the right side and probes
    with the left (reference role: ray.data joins via hash shuffle,
    _internal/planner/exchange + Dataset.join). `how`: "inner" or
    "left". Duplicate non-key columns from the right get a "_1"
    suffix."""
    import ray_tpu_torch

    P = max(1, num_partitions)

    def make_map(fused):
        @ray_tpu_torch.remote(num_cpus=1, num_returns=P)
        def _map(block):
            from ray_tpu_torch.data.block import to_rows

            buckets: list[list] = [[] for _ in range(P)]
            for r in to_rows(fused(block)):
                buckets[_stable_hash(r[on]) % P].append(r)
            return tuple(buckets) if P > 1 else buckets[0]

        return _map

    @ray_tpu_torch.remote(num_cpus=1)
    def _join(p, n_left, *parts):
        left_rows = [r for part in parts[:n_left] for r in part]
        right_by_key: dict = {}
        for part in parts[n_left:]:
            for r in part:
                right_by_key.setdefault(r[on], []).append(r)
        out = []
        for lr in left_rows:
            matches = right_by_key.get(lr[on])
            if matches:
                for rr in matches:
                    merged = dict(lr)
                    for k, v in rr.items():
                        if k == on:
                            continue
                        merged[k if k not in merged else k + "_1"] = v
                    out.append(merged)
            elif how == "left":
                out.append(dict(lr))
        return out

    lmap, rmap = make_map(left_fused), make_map(right_fused)
    louts = [lmap.remote(ref) for ref in left_refs]
    routs = [rmap.remote(ref) for ref in right_refs]
    if P == 1:
        louts = [[r] for r in louts]
        routs = [[r] for r in routs]
    return [
        _join.remote(p, len(louts),
                     *[m[p] for m in louts], *[m[p] for m in routs])
        for p in range(P)
    ]
