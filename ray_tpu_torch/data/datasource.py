"""Datasource ABC — pluggable lazy readers behind read_*(): the port's
copy of ``ray_tpu/data/datasource.py``. pyarrow is imported only inside
`ParquetDatasource.read_file`, so the package imports where it is
absent.

Reference parity: data/datasource/datasource.py (Datasource +
ReadTask: `get_read_tasks(parallelism)` returns serializable thunks
that materialize blocks INSIDE read tasks, never on the driver) and
read_api.py's `read_datasource`. The built-in text/csv/jsonl/parquet
readers are FileDatasource instances; users plug custom sources by
subclassing Datasource.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable


class ReadTask:
    """A serializable thunk producing one block, plus metadata the
    planner can use (reference: datasource.py ReadTask)."""

    def __init__(self, read_fn: Callable[[], list],
                 input_files: list[str] | None = None,
                 size_bytes: int | None = None):
        self._read_fn = read_fn
        self.input_files = input_files or []
        self.size_bytes = size_bytes

    def __call__(self) -> list:
        return self._read_fn()


class Datasource:
    """ABC. Implement `get_read_tasks`; optionally estimate size so
    the planner can choose parallelism."""

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def get_block_streams(self, parallelism: int) -> list[Callable]:
        """Streaming form: a list of thunks, each a GENERATOR yielding
        blocks incrementally. Runs under num_returns="streaming" read
        tasks so downstream consumes block 0 while the task is still
        producing block k (reference: streaming read tasks feeding the
        StreamingExecutor). Default adapts get_read_tasks: one yield per
        task."""
        tasks = self.get_read_tasks(parallelism)

        def make(t):
            def gen():
                yield t()

            return gen

        return [make(t) for t in tasks]

    def estimate_inmemory_data_size(self) -> int | None:
        return None

    @property
    def name(self) -> str:
        return type(self).__name__


class RangeDatasource(Datasource):
    def __init__(self, n: int):
        self.n = n

    def estimate_inmemory_data_size(self):
        return self.n * 8

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if self.n <= 0:
            return [ReadTask(lambda: [], size_bytes=0)]
        parallelism = max(1, min(parallelism, self.n or 1))
        per = -(-self.n // parallelism)
        tasks = []
        for lo in range(0, self.n, per):
            hi = min(self.n, lo + per)
            tasks.append(ReadTask(
                lambda lo=lo, hi=hi: list(range(lo, hi)),
                size_bytes=(hi - lo) * 8))
        return tasks


def _expand_paths(paths) -> list[str]:
    import glob as _glob

    out: list[str] = []
    for p in [paths] if isinstance(paths, str) else list(paths):
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if os.path.isfile(os.path.join(p, f))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths!r}")
    return out


class FileDatasource(Datasource):
    """One read task per file; subclasses define `read_file`."""

    def __init__(self, paths):
        self.paths = _expand_paths(paths)

    def read_file(self, path: str) -> list:
        raise NotImplementedError

    def estimate_inmemory_data_size(self):
        try:
            return sum(os.path.getsize(p) for p in self.paths)
        except OSError:
            return None

    def _groups(self, parallelism: int) -> list[list[str]]:
        groups: list[list[str]] = [[] for _ in
                                   range(min(parallelism, len(self.paths)))]
        for i, p in enumerate(self.paths):
            groups[i % len(groups)].append(p)
        return [g for g in groups if g]

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        # one task per file (files are the natural split unit); the
        # `parallelism` hint can only coarsen by grouping
        read = self.read_file

        def make(group):
            def rd():
                out: list = []
                for p in group:
                    out.extend(read(p))
                return out

            size = None
            try:
                size = sum(os.path.getsize(p) for p in group)
            except OSError:
                pass
            return ReadTask(rd, input_files=group, size_bytes=size)

        return [make(g) for g in self._groups(parallelism)]

    def get_block_streams(self, parallelism: int) -> list[Callable]:
        """One generator per file group, ONE BLOCK PER FILE: with grouped
        files the first file's rows are consumable while the rest of the
        group is still being read."""
        read = self.read_file

        def make(group):
            def gen():
                for p in group:
                    yield read(p)

            return gen

        return [make(g) for g in self._groups(parallelism)]


class TextDatasource(FileDatasource):
    def read_file(self, path: str) -> list:
        from ray_tpu_torch.data.lineio import read_lines

        return read_lines(path)


class CSVDatasource(FileDatasource):
    def read_file(self, path: str) -> list:
        import csv

        with open(path, newline="") as f:
            return [dict(r) for r in csv.DictReader(f)]


class JSONLDatasource(FileDatasource):
    def read_file(self, path: str) -> list:
        import json

        from ray_tpu_torch.data.lineio import read_lines

        return [json.loads(line) for line in read_lines(path)
                if line.strip()]


class ParquetDatasource(FileDatasource):
    def __init__(self, paths, columns: list[str] | None = None):
        super().__init__(paths)
        self.columns = columns

    def read_file(self, path: str) -> list:
        import pyarrow.parquet as pq

        return pq.read_table(path, columns=self.columns).to_pylist()


class ItemsDatasource(Datasource):
    """In-memory items (from_items role) through the same seam."""

    def __init__(self, items: Iterable[Any], parallelism_hint: int = 8):
        self.items = list(items)
        self.hint = parallelism_hint

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        from ray_tpu_torch.data.block import split_blocks

        blocks = split_blocks(self.items, parallelism or self.hint)
        return [ReadTask(lambda b=b: list(b), size_bytes=None)
                for b in blocks]
