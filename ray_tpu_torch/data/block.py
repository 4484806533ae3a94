"""Blocks — the unit of data movement: the port's copy of
``ray_tpu/data/block.py`` (numpy only).

Reference parity: ray.data blocks (Arrow tables in plasma,
data/_internal/arrow_block.py). A block is EITHER

- a list of rows (any python values; commonly dicts) — the row format
  for python-level ops, or
- a COLUMNAR block: dict of numpy column arrays (or one bare ndarray
  for unnamed values) — the Arrow-table role. On the local runtime a
  block passes between tasks by reference, so a columnar block is never
  copied on its way; `map_batches(batch_format="numpy")` and
  `iter_torch_batches` consume them without ever materializing rows.

Row <-> columnar conversion happens lazily at the operator that needs
the other form (row UDFs convert to rows; batch UDFs/iterators convert
to columns).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

Block = list  # historical alias; see module docstring for the union


def is_columnar(block: Any) -> bool:
    if isinstance(block, np.ndarray):
        return True
    return isinstance(block, dict) and \
        all(isinstance(v, np.ndarray) for v in block.values())


def rows_to_batch(rows: list) -> Any:
    """list of rows -> batch. Dict rows become dict-of-numpy columns;
    scalar/array rows become one numpy array."""
    if not rows:
        return {}
    if isinstance(rows[0], dict):
        keys = rows[0].keys()
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return np.asarray(rows)


def batch_to_rows(batch: Any) -> list:
    if isinstance(batch, dict):
        if not batch:
            return []
        n = len(next(iter(batch.values())))
        return [{k: v[i] for k, v in batch.items()} for i in range(n)]
    return list(batch)


def to_batch(block: Any) -> Any:
    """Block -> columnar batch (no-op when already columnar)."""
    return block if is_columnar(block) else rows_to_batch(block)


def to_rows(block: Any) -> list:
    """Block -> row list (no-op when already rows)."""
    return batch_to_rows(block) if is_columnar(block) else block


def block_num_rows(block: Any) -> int:
    if isinstance(block, np.ndarray):
        return len(block)
    if isinstance(block, dict):
        return len(next(iter(block.values()))) if block else 0
    return len(block)


def slice_block(block: Any, start: int, stop: int) -> Any:
    """Row-range slice in the block's own format (columnar slices are
    numpy views — zero copy)."""
    if isinstance(block, dict):
        return {k: v[start:stop] for k, v in block.items()}
    return block[start:stop]


def concat_batches(batches: list) -> Any:
    """Concatenate columnar batches row-wise. Single input passes
    through unconcatenated (a view — the common aligned case). Mixed
    kinds (dict-of-columns vs bare array, or differing column sets)
    raise — the Arrow-table role demands one schema per stream."""
    batches = [b for b in batches if block_num_rows(b)]
    if not batches:
        return {}
    if len(batches) == 1:
        return batches[0]
    if not columnar_kinds_compatible(batches):
        raise ValueError(
            "cannot concatenate columnar blocks with different schemas "
            f"({[sorted(b) if isinstance(b, dict) else type(b).__name__ for b in batches]}); "
            "materialize to rows first (e.g. via a row op)")
    if isinstance(batches[0], dict):
        return {k: np.concatenate([b[k] for b in batches])
                for k in batches[0]}
    return np.concatenate(batches)


def columnar_kinds_compatible(batches: list) -> bool:
    """True when the columnar batches share one schema (all bare arrays,
    or all dicts with the same column names)."""
    if all(isinstance(b, np.ndarray) for b in batches):
        return True
    if all(isinstance(b, dict) for b in batches):
        keys = set(batches[0])
        return all(set(b) == keys for b in batches)
    return False


def block_size_rows(block: Block) -> int:
    return block_num_rows(block)


def split_blocks(items: Iterable, num_blocks: int) -> list[Block]:
    items = list(items)
    n = max(1, num_blocks)
    base, rem = divmod(len(items), n)
    out, i = [], 0
    for b in range(n):
        size = base + (1 if b < rem else 0)
        out.append(items[i:i + size])
        i += size
    return [b for b in out if b] or [[]]


def split_columnar(batch: Any, num_blocks: int) -> list:
    """Split one columnar batch into ~equal columnar blocks (views)."""
    total = block_num_rows(batch)
    n = max(1, num_blocks)
    base, rem = divmod(total, n)
    out, i = [], 0
    for b in range(n):
        size = base + (1 if b < rem else 0)
        if size:
            out.append(slice_block(batch, i, i + size))
        i += size
    return out or [slice_block(batch, 0, 0)]
