"""The port's data layer (ray_tpu_torch.data) against the JAX package's
(ray_tpu.data), both on their local runtimes: every scenario of
tests/test_data.py, tests/test_data_exchange.py and
tests/test_data_plan.py (the ones the JAX files mark slow included, at
the same sizes) runs through ``ray_tpu.init(local_mode=True)`` and
``ray_tpu_torch.init(local_mode=True)`` in turn, on the same seeded
inputs. Scenarios return what the JAX tests assert on, in the order the
pipeline gives it (the seeded shuffle's order included), with
``explain()`` strings; the two must be equal. Then what only the port
has: the native line scanner built by ``_build.build_host`` against the
Python split and against the JAX package's reader,
`iter_torch_batches` on the CPU against `iter_jax_batches` (and its
refusal of a missing card), a (data=2, fsdp=2) mesh of four gloo ranks
whose batches arrive as DTensors of 4 local rows, `get_dataset_shard`,
and a streaming read that really streams."""

import json
import os
import threading
from builtins import range as builtins_range
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jax_data
import ray_tpu.data.datasource as jax_ds
import ray_tpu.data.plan as jax_plan
import ray_tpu_torch
import ray_tpu_torch.data as port_data
import ray_tpu_torch.data.datasource as port_ds
import ray_tpu_torch.data.plan as port_plan
from tests.test_torch_collectives import run_ranks

PACKAGES = {
    "jax": SimpleNamespace(ray=ray_tpu, rd=jax_data, plan=jax_plan,
                           ds=jax_ds),
    "port": SimpleNamespace(ray=ray_tpu_torch, rd=port_data,
                            plan=port_plan, ds=port_ds),
}


def _norm(x):
    """Comparable plain values: arrays to lists, numpy scalars to
    Python, tuples to lists."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return _norm(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


# ------------------------------------------------------------ test_data.py
# each scenario takes the package namespace and a scratch directory


def range_count_sum(p, tmp):
    ds = p.rd.range(100, parallelism=8)
    return ds.count(), ds.sum(), ds.num_blocks()


def map_filter_chain_fused(p, tmp):
    ds = p.rd.range(50).map(lambda x: x * 2).filter(lambda x: x % 4 == 0)
    return ds.explain(), ds.take_all()


def flat_map(p, tmp):
    return p.rd.from_items([1, 2, 3], parallelism=2).flat_map(
        lambda x: [x] * x).take_all()


def map_batches_numpy(p, tmp):
    ds = p.rd.from_items([{"x": float(i)} for i in range(32)],
                         parallelism=4)
    out = ds.map_batches(lambda b: {"y": b["x"] * 10})
    return out.explain(), out.take_all()


def map_batches_actor_pool(p, tmp):
    def heavy(b):
        return {"y": b["x"] + 1}

    ds = p.rd.from_items([{"x": float(i)} for i in range(24)],
                         parallelism=6)
    return ds.map_batches(heavy, compute="actors", num_actors=2).take_all()


def iter_batches_rebatching(p, tmp):
    batches = list(p.rd.range(25, parallelism=4).iter_batches(
        batch_size=10))
    return [len(b) for b in batches], batches


def shard_for_train_ingestion(p, tmp):
    shards = p.rd.range(64, parallelism=8).map(lambda x: x + 1).split(2)
    return [s.take_all() for s in shards], shards[0].num_blocks()


def repartition_and_materialize(p, tmp):
    m = p.rd.range(40, parallelism=4).map(lambda x: x * 3).materialize()
    r = m.repartition(10)
    return m.num_blocks(), r.num_blocks(), r.take_all()


def take_streams_lazily(p, tmp):
    return p.rd.range(1000, parallelism=16).map(lambda x: x).take(5)


def read_text_and_write_jsonl(p, tmp):
    for i in range(3):
        with open(os.path.join(tmp, f"f{i}.txt"), "w") as f:
            f.write(f"line-{i}a\nline-{i}b\n")
    ds = p.rd.read_text(os.path.join(tmp, "*.txt"))
    rows = ds.take_all()
    out = ds.map(lambda line: {"text": line}).write_jsonl(
        os.path.join(tmp, "out"))
    back = p.rd.read_json(os.path.join(tmp, "out")).take_all()
    return rows, [os.path.basename(f) for f in out], back


def read_csv(p, tmp):
    path = os.path.join(tmp, "d.csv")
    with open(path, "w") as f:
        f.write("a,b\n1,x\n2,y\n")
    return p.rd.read_csv(path).take_all()


def limit_pushdown_and_global_cap(p, tmp):
    ds = p.rd.range(1000, parallelism=8).map(lambda x: x * 2).limit(5)
    return ds.explain(), ds.take_all(), ds.count()


def read_datasource_custom(p, tmp):
    class Squares(p.rd.Datasource):
        def get_read_tasks(self, parallelism):
            return [p.rd.ReadTask(lambda lo=lo: [x * x for x in
                                                 builtins_range(lo, lo + 5)])
                    for lo in (0, 5)]

    return p.rd.read_datasource(Squares()).take_all()


def limit_global_before_non_one_to_one(p, tmp):
    out = (p.rd.range(20, parallelism=2).limit(5)
           .flat_map(lambda r: [r, r]).take_all())
    shuffled = p.rd.range(100, parallelism=4).limit(7).random_shuffle(
        seed=1).take_all()
    return out, shuffled, p.rd.range(50, parallelism=4).limit(9).count()


def limit_respected_by_writers_and_materialize(p, tmp):
    ds = p.rd.range(100, parallelism=8).limit(5)
    files = ds.write_jsonl(os.path.join(tmp, "j"))
    rows = [json.loads(line) for f in files for line in open(f)]
    return ds.materialize().count(), rows, repr(ds)


# --------------------------------------------------- test_data_exchange.py


def random_shuffle_preserves_multiset(p, tmp):
    return p.rd.range(1000, parallelism=8).random_shuffle(seed=7).take_all()


def random_shuffle_deterministic_with_seed(p, tmp):
    a = p.rd.range(500, parallelism=4).random_shuffle(seed=3).take_all()
    b = p.rd.range(500, parallelism=4).random_shuffle(seed=3).take_all()
    return a, b


def sort_scalars_multi_block(p, tmp):
    rng = np.random.RandomState(0)
    vals = [int(v) for v in rng.randint(0, 10_000, 2_000)]
    return p.rd.from_items(vals, parallelism=8).sort().take_all()


def sort_by_column_descending(p, tmp):
    rows = [{"k": i % 17, "v": i} for i in range(400)]
    return p.rd.from_items(rows, parallelism=6).sort(
        "k", descending=True).take_all()


def sort_after_map(p, tmp):
    return p.rd.range(100, parallelism=5).map(
        lambda x: 99 - x).sort().take_all()


def groupby_aggregate_matches_inmemory(p, tmp):
    rng = np.random.RandomState(1)
    rows = [{"k": int(k), "v": float(v)}
            for k, v in zip(rng.randint(0, 13, 1_500),
                            rng.rand(1_500) * 10)]
    return p.rd.from_items(rows, parallelism=8).groupby("k").aggregate(
        p.rd.Count(), p.rd.Sum("v"), p.rd.Mean("v"), p.rd.Min("v"),
        p.rd.Max("v"), p.rd.Std("v")).take_all()


def groupby_map_groups(p, tmp):
    rows = [{"k": i % 3, "v": i} for i in range(30)]
    return p.rd.from_items(rows, parallelism=4).groupby("k").map_groups(
        lambda rs: {"k": rs[0]["k"], "n": len(rs)}).take_all()


def join_inner_and_left(p, tmp):
    left = p.rd.from_items([{"id": i, "a": i * 2} for i in range(20)],
                           parallelism=3)
    right = p.rd.from_items([{"id": i, "a": -i} for i in range(0, 30, 3)],
                            parallelism=2)
    return (left.join(right, on="id").take_all(),
            left.join(right, on="id", how="left").take_all())


def union_and_zip(p, tmp):
    a = p.rd.range(10, parallelism=2)
    b = p.rd.range(5, parallelism=1).map(lambda x: x + 100)
    z = p.rd.from_numpy({"x": np.arange(12)}, parallelism=3).zip(
        p.rd.from_numpy({"x": np.arange(12) * 2}, parallelism=2))
    return a.union(b).take_all(), z.take_all(), p.rd.range(6).unique()


def parquet_round_trip(p, tmp):
    rows = [{"a": i, "b": float(i) / 3, "s": f"row{i}"} for i in range(200)]
    paths = p.rd.from_items(rows, parallelism=4).write_parquet(
        os.path.join(tmp, "pq"))
    back = p.rd.read_parquet(os.path.join(tmp, "pq")).take_all()
    only_a = p.rd.read_parquet(os.path.join(tmp, "pq"),
                               columns=["a"]).take_all()
    return [os.path.basename(x) for x in paths], back, only_a


def pyarrow_batch_format(p, tmp):
    def double(table):
        import pyarrow.compute as pc

        return table.set_column(0, "x", pc.multiply(table["x"], 2))

    rows = [{"x": i} for i in range(100)]
    out = p.rd.from_items(rows, parallelism=4).map_batches(
        double, batch_format="pyarrow").take_all()
    batches = list(p.rd.from_items(rows, parallelism=2).iter_batches(
        batch_size=40, batch_format="pyarrow"))
    return out, [type(b).__name__ for b in batches], \
        [b.to_pylist() for b in batches]


def shuffled_train_ingestion(p, tmp):
    shards = p.rd.range(512, parallelism=8).random_shuffle(
        seed=11).split(4)
    seen = [[int(v) for batch in sh.iter_batches(batch_size=32)
             for v in batch] for sh in shards]
    plain_shard0 = p.rd.range(512, parallelism=8).split(4)[0].take_all()
    return seen, shards[0].take_all() != plain_shard0


def memory_budget_bounds_buffered_bytes(p, tmp):
    import time as _t

    ds = p.rd.from_items(list(range(16)), parallelism=16).map_batches(
        lambda b: np.zeros((len(b), 64 * 1024), np.float32))
    out = []
    for ref in ds._execute(max_in_flight=8, memory_budget=2 * (1 << 20)):
        _t.sleep(0.05)  # slow consumer
        out.append(p.ray.get(ref).shape)
    st = ds._last_executor.stats
    return (out, st.backpressure_waits > 0,
            st.peak_buffered_bytes < 12 * (1 << 20))


def executor_preserves_order_and_results(p, tmp):
    ds = p.rd.range(200, parallelism=10).map(lambda x: x * 3)
    out = ds.take_all()
    st = ds._last_executor.stats
    return out, st.submitted, st.yielded


def seeded_shuffle_not_position_aligned(p, tmp):
    ds = p.rd.from_items(list(range(100)), parallelism=2).random_shuffle(
        seed=7)
    parts = p.ray.get(list(ds._block_refs), timeout=120)
    same = sum(1 for i in range(50)
               if any(i in q and i + 50 in q for q in parts))
    return parts, same


# ------------------------------------------------------ test_data_plan.py


def limit_pushes_past_one_to_one_maps(p, tmp):
    ops = [p.plan.MapRows(lambda x: x * 2), p.plan.MapRows(lambda x: x + 1),
           p.plan.Limit(3)]
    out = p.plan.LimitPushdown().apply(ops)
    plan = p.plan.LogicalPlan(ops)
    return ([o.name for o in out], plan.compile()(list(range(10))),
            plan.optimized().describe())


def limit_blocked_by_filter(p, tmp):
    ops = [p.plan.FilterRows(lambda x: x % 2 == 0), p.plan.Limit(2)]
    out = p.plan.LimitPushdown().apply(ops)
    return ([o.name for o in out],
            p.plan.LogicalPlan(ops).compile()(list(range(10))))


def adjacent_limits_collapse(p, tmp):
    out = p.plan.RedundantLimitElimination().apply(
        [p.plan.Limit(5), p.plan.Limit(2), p.plan.Limit(9)])
    return [o.n for o in out]


def map_fusion_single_operator(p, tmp):
    ops = [p.plan.MapRows(lambda x: x + 1),
           p.plan.FilterRows(lambda x: x > 2),
           p.plan.MapRows(lambda x: x * 10)]
    fused = p.plan.MapFusion().apply(ops)
    return ([type(f).__name__ for f in fused],
            fused[0].block_fn()([0, 1, 2, 3]),
            p.plan.LogicalPlan(fused).describe())


def plan_describe_and_global_limit(p, tmp):
    plan = p.plan.LogicalPlan([p.plan.MapRows(lambda x: x),
                               p.plan.Limit(7)])
    return (plan.describe(), plan.global_limit(),
            p.plan.LogicalPlan([p.plan.Limit(7),
                                p.plan.FilterRows(lambda x: True)])
            .global_limit())


def empty_plan_identity(p, tmp):
    return p.plan.LogicalPlan([]).compile()([1, 2]), \
        p.plan.LogicalPlan([]).describe()


def range_datasource_partitions(p, tmp):
    tasks = p.ds.RangeDatasource(10).get_read_tasks(3)
    return ([r for t in tasks for r in t()],
            p.ds.RangeDatasource(10).estimate_inmemory_data_size())


def items_datasource(p, tmp):
    tasks = p.ds.ItemsDatasource(["a", "b", "c"]).get_read_tasks(2)
    return [r for t in tasks for r in t()]


def file_datasources(p, tmp):
    with open(os.path.join(tmp, "a.txt"), "w") as f:
        f.write("x\ny\n")
    with open(os.path.join(tmp, "b.csv"), "w") as f:
        f.write("k,v\n1,2\n3,4\n")
    with open(os.path.join(tmp, "c.jsonl"), "w") as f:
        f.write('{"n": 1}\n{"n": 2}\n')
    t = p.ds.TextDatasource(os.path.join(tmp, "a.txt"))
    c = p.ds.CSVDatasource(os.path.join(tmp, "b.csv"))
    j = p.ds.JSONLDatasource(os.path.join(tmp, "c.jsonl"))
    return ([r for task in t.get_read_tasks(4) for r in task()],
            t.estimate_inmemory_data_size(),
            [r for task in c.get_read_tasks(1) for r in task()],
            [r for task in j.get_read_tasks(1) for r in task()])


def file_datasource_grouping_honors_parallelism(p, tmp):
    for i in range(6):
        with open(os.path.join(tmp, f"f{i}.txt"), "w") as f:
            f.write(f"{i}\n")
    tasks = p.ds.TextDatasource(tmp).get_read_tasks(2)
    return (len(tasks), [r for t in tasks for r in t()],
            [[os.path.basename(x) for x in t.input_files] for t in tasks])


def custom_datasource_contract(p, tmp):
    class Fib(p.ds.Datasource):
        def get_read_tasks(self, parallelism):
            return [p.ds.ReadTask(lambda: [1, 1, 2, 3, 5])]

    return [r for t in Fib().get_read_tasks(1) for r in t()]


def missing_files_error(p, tmp):
    try:
        p.ds.TextDatasource("/definitely/not/here/*.txt")
    except FileNotFoundError as e:
        return "FileNotFoundError", str(e)
    return "no error"


def read_parallelism_defaults_to_one_task_per_file(p, tmp):
    for i in range(12):
        with open(os.path.join(tmp, f"f{i}.txt"), "w") as f:
            f.write(f"{i}\n")
    ds2 = p.rd.read_text(tmp, parallelism=3)
    return (p.rd.read_text(tmp).num_blocks(), ds2.num_blocks(),
            ds2.take_all())


def streaming_read(p, tmp):
    for i in range(5):
        with open(os.path.join(tmp, f"s{i}.txt"), "w") as f:
            f.write(f"{i}a\n{i}b\n")
    ds = p.rd.read_text(tmp, parallelism=2, streaming=True)
    return ds.map(lambda s: s.upper()).take_all()


SCENARIOS = [
    range_count_sum, map_filter_chain_fused, flat_map, map_batches_numpy,
    map_batches_actor_pool, iter_batches_rebatching,
    shard_for_train_ingestion, repartition_and_materialize,
    take_streams_lazily, read_text_and_write_jsonl, read_csv,
    limit_pushdown_and_global_cap, read_datasource_custom,
    limit_global_before_non_one_to_one,
    limit_respected_by_writers_and_materialize,
    random_shuffle_preserves_multiset,
    random_shuffle_deterministic_with_seed, sort_scalars_multi_block,
    sort_by_column_descending, sort_after_map,
    groupby_aggregate_matches_inmemory, groupby_map_groups,
    join_inner_and_left, union_and_zip, parquet_round_trip,
    pyarrow_batch_format, shuffled_train_ingestion,
    memory_budget_bounds_buffered_bytes,
    executor_preserves_order_and_results,
    seeded_shuffle_not_position_aligned,
    limit_pushes_past_one_to_one_maps, limit_blocked_by_filter,
    adjacent_limits_collapse, map_fusion_single_operator,
    plan_describe_and_global_limit, empty_plan_identity,
    range_datasource_partitions, items_datasource, file_datasources,
    file_datasource_grouping_honors_parallelism,
    custom_datasource_contract, missing_files_error,
    read_parallelism_defaults_to_one_task_per_file, streaming_read,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_data_matches_jax(scenario, tmp_path):
    got = {}
    for name, p in PACKAGES.items():
        tmp = tmp_path / name
        tmp.mkdir()
        p.ray.init(local_mode=True, num_cpus=8)
        try:
            got[name] = _norm(scenario(p, str(tmp)))
        finally:
            p.ray.shutdown()
    assert got["port"] == got["jax"]


def test_expected_outcomes(tmp_path):
    """The JAX tests' own assertions hold on the port (the parity test
    above would also pass if both packages were wrong the same way)."""
    p = PACKAGES["port"]
    ray_tpu_torch.init(local_mode=True, num_cpus=8)
    try:
        assert range_count_sum(p, None) == (100, 4950, 8)
        explain, rows = map_filter_chain_fused(p, None)
        assert rows == [x * 2 for x in range(50) if (x * 2) % 4 == 0]
        assert explain == "Fused[Read->MapRows->Filter]"
        assert sorted(r["y"] for r in map_batches_actor_pool(p, None)) == \
            [i + 1.0 for i in range(24)]
        assert iter_batches_rebatching(p, None)[0] == [10, 10, 5]
        explain, rows, count = limit_pushdown_and_global_cap(p, None)
        assert "Limit" in explain and rows == [0, 2, 4, 6, 8] and count == 5
        out = random_shuffle_preserves_multiset(p, None)
        assert sorted(out) == list(range(1000)) and out != list(range(1000))
        a, b = random_shuffle_deterministic_with_seed(p, None)
        assert a == b
        rng = np.random.RandomState(0)
        assert sort_scalars_multi_block(p, None) == sorted(
            int(v) for v in rng.randint(0, 10_000, 2_000))
        seen, differs = shuffled_train_ingestion(p, None)
        assert sorted(v for s in seen for v in s) == list(range(512))
        assert differs
        _, waited, bounded = memory_budget_bounds_buffered_bytes(p, None)
        assert waited and bounded
        assert executor_preserves_order_and_results(p, None)[1:] == (10, 10)
        assert seeded_shuffle_not_position_aligned(p, None)[1] < 45
        tmp = tmp_path / "read"
        tmp.mkdir()
        # two producers over files grouped round-robin, drained in turn
        assert streaming_read(p, str(tmp)) == [
            f"{i}{s}".upper() for i in (0, 2, 4, 1, 3) for s in "ab"]
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------------------- line scanner

LINE_CASES = {
    "plain": "a\nbb\nccc\n",
    "no_trailing_newline": "x\ny",
    "empty_lines": "\n\na\n\n",
    "empty_file": "",
    "one_line": "only",
}


def test_native_lineio_matches_python(tmp_path):
    """The native scanner, built from ``csrc/lineio.cc`` by
    ``_build.build_host`` into ``build/``, agrees with Python's split and
    with the JAX package's reader on the edge cases of test_data.py."""
    from ray_tpu.data.lineio import read_lines as jax_read_lines

    from ray_tpu_torch import _build
    from ray_tpu_torch.data import lineio

    for name, content in LINE_CASES.items():
        path = tmp_path / f"{name}.txt"
        path.write_text(content)
        assert lineio.read_lines(str(path)) == content.splitlines(), name
        assert lineio.read_lines(str(path)) == jax_read_lines(str(path))
    assert lineio.native(), "native lineio failed to build"
    lib = _build.host_library_path("lineio")
    assert os.path.dirname(lib) == _build.BUILD_DIR and os.path.exists(lib)


def test_native_lineio_keep_newlines_and_errors(tmp_path):
    from ray_tpu_torch.data.lineio import read_lines

    p = tmp_path / "t.txt"
    p.write_text("a\nb")  # unterminated final line
    assert read_lines(str(p), strip_newline=False) == ["a\n", "b"]
    p2 = tmp_path / "crlf.txt"
    p2.write_bytes(b"x\r\ny\r\n")
    assert read_lines(str(p2)) == ["x", "y"]
    with pytest.raises(FileNotFoundError):
        read_lines(str(tmp_path / "missing.txt"))
    with pytest.raises(IsADirectoryError):
        read_lines(str(tmp_path))


def test_lineio_python_path_without_a_compiler(tmp_path, monkeypatch):
    """With no host compiler the reader takes JAX's pure-Python path and
    says so."""
    from ray_tpu_torch import _build
    from ray_tpu_torch.data import lineio

    monkeypatch.setattr(_build, "host_library_path",
                        lambda name: str(tmp_path / "absent.so"))
    monkeypatch.setattr(_build, "host_cxx", lambda: None)
    monkeypatch.setattr(lineio, "_lib", None)
    path = tmp_path / "t.txt"
    path.write_text(LINE_CASES["empty_lines"])
    assert lineio.read_lines(str(path)) == ["", "", "a", ""]
    assert not lineio.native()


# ------------------------------------------------------ iter_torch_batches


def _dict_rows():
    return [{"x": np.full((4,), i, np.float32), "y": i} for i in range(50)]


@pytest.mark.parametrize("case", [
    ("range", 8, False), ("range", 8, True), ("dict", 16, True),
    ("dict", 16, False)], ids=lambda c: f"{c[0]}-{c[1]}-drop{c[2]}")
def test_iter_torch_batches_equals_iter_jax_batches(case):
    """`iter_torch_batches(device="cpu")` hands out the arrays
    `iter_jax_batches` does, as torch tensors (int64 stays int64 where
    JAX makes int32), with the drop_last cases of test_data.py."""
    import jax

    kind, batch_size, drop_last = case
    out = {}
    for name, p in PACKAGES.items():
        p.ray.init(local_mode=True, num_cpus=8)
        try:
            ds = (p.rd.range(20, parallelism=2) if kind == "range"
                  else p.rd.from_items(_dict_rows(), parallelism=5))
            if name == "jax":
                it = ds.iter_jax_batches(batch_size=batch_size,
                                         drop_last=drop_last)
                out[name] = [jax.tree.map(np.asarray, b) for b in it]
            else:
                it = ds.iter_torch_batches(batch_size=batch_size,
                                           drop_last=drop_last,
                                           device="cpu")
                out[name] = list(it)
        finally:
            p.ray.shutdown()
    assert len(out["port"]) == len(out["jax"])
    for got, want in zip(out["port"], out["jax"]):
        got = got if isinstance(got, dict) else {"": got}
        want = want if isinstance(want, dict) else {"": want}
        assert sorted(got) == sorted(want)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
            if want[k].dtype.kind == "i":
                assert got[k].dtype == torch.int64
    sizes = [len(b["x"] if isinstance(b, dict) else b) for b in out["port"]]
    assert sizes == {("range", False): [8, 8, 4], ("range", True): [8, 8],
                     ("dict", True): [16, 16, 16],
                     ("dict", False): [16, 16, 16, 2]}[(kind, drop_last)]


def test_iter_torch_batches_copies_and_needs_the_card():
    """A CPU batch is a copy (a consumer writing it leaves the dataset's
    block alone), and with no device named the iterator wants the card:
    on a machine without one it raises, never falls back to the CPU."""
    ray_tpu_torch.init(local_mode=True)
    try:
        ds = port_data.from_numpy({"a": np.arange(8)}, parallelism=1)
        b = next(ds.iter_torch_batches(batch_size=8, device="cpu"))
        b["a"].zero_()
        assert ds.take_all()[3]["a"] == 3
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                next(ds.iter_torch_batches(batch_size=8))
    finally:
        ray_tpu_torch.shutdown()


def _mesh_batches_body(rank):
    """On each rank: the local runtime, a (data=2, fsdp=2) gloo mesh, and
    the 50 rows of test_data.py's sharded case in batches of 16."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(data=2, fsdp=2), device="cpu")
    ray_tpu_torch.init(local_mode=True)
    try:
        ds = port_data.from_items(_dict_rows(), parallelism=5)
        out = []
        for batch in ds.iter_torch_batches(batch_size=16, mesh=mesh):
            assert isinstance(batch["x"], DTensor)
            out.append({k: (tuple(v.shape), tuple(v.to_local().shape),
                            v.to_local().numpy(), v.full_tensor().numpy())
                        for k, v in batch.items()})
        try:
            next(ds.iter_torch_batches(batch_size=16, mesh=mesh,
                                       drop_last=False))
            refused = False
        except ValueError:
            refused = True
    finally:
        ray_tpu_torch.shutdown()
    return out, refused


def test_iter_torch_batches_on_a_mesh(tmp_path):
    """test_data.py's sharded case on four gloo ranks (it uses eight
    devices): every 16-row batch is a DTensor sharded over data x fsdp,
    each rank's local shard its own 4 rows of the global batch;
    drop_last=False with a mesh raises ValueError."""
    ranks = run_ranks(_mesh_batches_body, tmp_path)
    rows = _dict_rows()
    for rank, (batches, refused) in enumerate(ranks):
        assert refused
        assert len(batches) == 3  # 50 rows -> 3 full batches
        for i, b in enumerate(batches):
            want_x = np.stack([r["x"] for r in rows[16 * i:16 * i + 16]])
            want_y = np.asarray([r["y"] for r in rows[16 * i:16 * i + 16]])
            assert b["x"][:2] == ((16, 4), (4, 4))
            assert b["y"][:2] == ((16,), (4,))
            np.testing.assert_array_equal(b["x"][3], want_x)
            np.testing.assert_array_equal(b["y"][3], want_y)
            np.testing.assert_array_equal(
                b["x"][2], want_x[4 * rank:4 * rank + 4])


# --------------------------------------------------------- dataset shards


def test_get_dataset_shard_inside_and_outside_a_session():
    from ray_tpu_torch.train import get_dataset_shard, session

    with pytest.raises(RuntimeError, match="outside a train worker"):
        get_dataset_shard()
    ray_tpu_torch.init(local_mode=True)
    try:
        shards = port_data.range(64, parallelism=8).split(2)
        ctx = session.TrainContext(2, 1, 1, 2, 0, "exp", "", None)
        session.init_session(ctx, dataset_shards={"train": shards[1]})
        try:
            assert get_dataset_shard("train") is shards[1]
            assert get_dataset_shard().take_all() == shards[1].take_all()
            with pytest.raises(KeyError, match="'eval'"):
                get_dataset_shard("eval")
        finally:
            session.shutdown_session()
    finally:
        ray_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match="outside a train worker"):
        get_dataset_shard()


def test_streaming_read_yields_before_the_read_ends():
    """Local mode streams a read task: the consumer gets the first block
    while the producer is still held before its second (a drained
    generator would never let go of it)."""
    release = threading.Event()

    class Gate(port_data.Datasource):
        def get_read_tasks(self, parallelism):
            raise AssertionError("streaming reads use block streams")

        def get_block_streams(self, parallelism):
            def gen():
                yield [1, 2]
                if not release.wait(30):
                    raise TimeoutError("the consumer never saw block 0")
                yield [3]

            return [gen]

    ray_tpu_torch.init(local_mode=True)
    try:
        it = port_data.read_datasource(Gate(), streaming=True).iter_rows()
        assert [next(it), next(it)] == [1, 2]
        release.set()
        assert list(it) == [3]
    finally:
        release.set()
        ray_tpu_torch.shutdown()
