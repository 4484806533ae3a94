"""The port's collectives (ray_tpu_torch.parallel.ops) on four gloo ranks
of the CPU, against numpy: psum, pmean, pmax, all_gather, reduce_scatter,
all_to_all, ppermute, ring_shift, axis_index and axis_size over each
axis of a (data=2, tensor=2) mesh, the gradients through all_gather,
reduce_scatter and psum, shard_map, and the collective counts read from
CommDebugMode.

The ranks are spawned once for the module (`run_ranks`, also used by
test_torch_zero.py): they meet through a FileStore under the test's tmp
directory (no port, so parallel test workers cannot collide), run every
case, and hand back numpy results. Nothing here imports jax, so the
rank processes never do."""

import multiprocessing
import os
import queue
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
MESH = {"data": 2, "tensor": 2}
# the ranks of each axis's groups on the (data=2, tensor=2) mesh, rank r
# at row-major position r
GROUPS = {"data": [[0, 2], [1, 3]], "tensor": [[0, 1], [2, 3]]}
RANK_TIMEOUT_S = 240


def _rank_main(fn, rank, world, store_path, args, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            results.put((rank, fn(rank, *args), None))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - handed to the parent
        results.put((rank, None, traceback.format_exc()))


def run_ranks(fn, tmp_path, *args, world: int = WORLD,
              timeout: float = RANK_TIMEOUT_S, meanwhile=None) -> list:
    """``fn(rank, *args)`` on `world` spawned processes joined in one
    gloo process group; returns each rank's result in rank order, or
    raises with the first rank's traceback. `fn` must be a module-level
    function of a module that imports no jax. ``meanwhile()``, if given,
    runs here while the ranks do, and the call returns
    ``(results, meanwhile())``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp_path), "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        extra = meanwhile() if meanwhile is not None else None
        for _ in range(world):
            rank, value, err = results.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            out[rank] = value
    except queue.Empty:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} "
                           f"gave no result in {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    ranked = [out[r] for r in range(world)]
    return ranked if meanwhile is None else (ranked, extra)


def _x(rank, shape, salt=0):
    rng = np.random.RandomState(100 * salt + rank)
    return rng.normal(size=shape).astype(np.float32)


def _collectives_body(rank):
    """Every case on this rank: {case: numpy result}."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.parallel import ops
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P, use_mesh

    mesh = build_mesh(MeshSpec(**MESH), device="cpu")
    out = {}

    def t(a):
        return torch.from_numpy(a)

    with use_mesh(mesh):
        for axis in ("data", "tensor"):
            x = t(_x(rank, (4, 6)))
            out[f"psum/{axis}"] = ops.psum(x, axis).numpy()
            out[f"pmean/{axis}"] = ops.pmean(x, axis).numpy()
            out[f"pmax/{axis}"] = ops.pmax(x, axis).numpy()
            out[f"all_gather/{axis}/0"] = ops.all_gather(x, axis).numpy()
            out[f"all_gather/{axis}/1"] = ops.all_gather(
                x, axis, axis=1).numpy()
            out[f"all_gather/{axis}/untiled"] = ops.all_gather(
                x, axis, tiled=False).numpy()
            out[f"reduce_scatter/{axis}/0"] = ops.reduce_scatter(
                x, axis).numpy()
            out[f"reduce_scatter/{axis}/1"] = ops.reduce_scatter(
                x, axis, scatter_dimension=1).numpy()
            out[f"all_to_all/{axis}"] = ops.all_to_all(
                x, axis, split_axis=1, concat_axis=0).numpy()
            out[f"ppermute/{axis}"] = ops.ppermute(x, axis,
                                                   [(0, 1)]).numpy()
            out[f"ring_shift/{axis}"] = ops.ring_shift(x, axis).numpy()
            out[f"axis/{axis}"] = np.array(
                [ops.axis_index(axis), ops.axis_size(axis)])
            # gradients: d/dx sum(w * op(x)) for a per-rank weight w
            for name, op in (
                    ("all_gather", lambda v: ops.all_gather(v, axis)),
                    ("reduce_scatter",
                     lambda v: ops.reduce_scatter(v, axis)),
                    ("psum", lambda v: ops.psum(v, axis)),
                    ("all_to_all", lambda v: ops.all_to_all(
                        v, axis, split_axis=1, concat_axis=0)),
                    ("ppermute", lambda v: ops.ring_shift(v, axis))):
                xg = x.clone().requires_grad_()
                y = op(xg)
                w = t(_x(rank, tuple(y.shape), salt=7))
                (y * w).sum().backward()
                out[f"grad/{name}/{axis}"] = xg.grad.numpy()
        # an axis the mesh dropped (size 1) is the identity
        x = t(_x(rank, (4, 6)))
        out["absent/psum"] = ops.psum(x, "fsdp").numpy()
        out["absent/axis"] = np.array([ops.axis_index("fsdp"),
                                       ops.axis_size("fsdp")])

    # shard_map: a global (8, 4) @ (4, 6) with rows over data and
    # columns over tensor, and a psum over data of column sums
    gx, gw = _x(0, (8, 4), salt=3), _x(0, (4, 6), salt=4)
    mm = ops.shard_map(lambda a, b: a @ b, mesh,
                       in_specs=(P("data", None), P(None, "tensor")),
                       out_specs=P("data", "tensor"))
    res = mm(t(gx), t(gw))
    out["shard_map/matmul"] = res.full_tensor().numpy()
    out["shard_map/local_shape"] = np.array(res.to_local().shape)
    colsum = ops.shard_map(lambda a: ops.psum(a.sum(0), "data"), mesh,
                           in_specs=P("data", None), out_specs=P())
    out["shard_map/psum"] = colsum(t(gx)).full_tensor().numpy()
    out["shard_map/is_dtensor"] = np.array(isinstance(res, DTensor))

    # collective counts: two explicit collectives and one redistribution
    with CommDebugMode() as comm:
        with use_mesh(mesh):
            ops.psum(t(_x(rank, (4,))), "data")
            ops.all_gather(t(_x(rank, (4,))), "tensor")
        res.redistribute(mesh, res.placements[:1] + (
            type(res.placements[0])(0),)).to_local()
    counts = ops.collective_op_counts(comm)
    out["counts"] = np.array([counts.get("allreduce", 0),
                              counts.get("all_gather", 0),
                              counts.get("reduce_scatter", 0)])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_collectives_body, tmp_path_factory.mktemp("coll"))


def _inputs(shape=(4, 6), salt=0):
    return [_x(r, shape, salt) for r in range(WORLD)]


def _group_of(axis, rank):
    return next(g for g in GROUPS[axis] if rank in g)


AXES = ("data", "tensor")
TOL = {"atol": 1e-5, "rtol": 1e-5}


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name", ["psum", "pmean", "pmax"])
def test_reductions(ranks, axis, name):
    xs = _inputs()
    for r in range(WORLD):
        g = np.stack([xs[m] for m in _group_of(axis, r)])
        want = {"psum": g.sum(0), "pmean": g.mean(0),
                "pmax": g.max(0)}[name]
        np.testing.assert_allclose(ranks[r][f"{name}/{axis}"], want, **TOL)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("form", ["0", "1", "untiled"])
def test_all_gather(ranks, axis, form):
    xs = _inputs()
    for r in range(WORLD):
        parts = [xs[m] for m in _group_of(axis, r)]
        want = {"0": np.concatenate(parts, 0),
                "1": np.concatenate(parts, 1),
                "untiled": np.stack(parts, 0)}[form]
        np.testing.assert_array_equal(
            ranks[r][f"all_gather/{axis}/{form}"], want)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter(ranks, axis, dim):
    xs = _inputs()
    for r in range(WORLD):
        grp = _group_of(axis, r)
        total = sum(xs[m] for m in grp)
        want = np.split(total, len(grp), axis=dim)[grp.index(r)]
        np.testing.assert_allclose(
            ranks[r][f"reduce_scatter/{axis}/{dim}"], want, **TOL)


@pytest.mark.parametrize("axis", AXES)
def test_all_to_all(ranks, axis):
    xs = _inputs()
    for r in range(WORLD):
        grp = _group_of(axis, r)
        i = grp.index(r)
        want = np.concatenate([np.split(xs[m], len(grp), axis=1)[i]
                               for m in grp], axis=0)
        np.testing.assert_array_equal(ranks[r][f"all_to_all/{axis}"], want)


@pytest.mark.parametrize("axis", AXES)
def test_ppermute_and_ring_shift(ranks, axis):
    xs = _inputs()
    for r in range(WORLD):
        grp = _group_of(axis, r)
        i = grp.index(r)
        # (0 -> 1): index 1 receives index 0's value, index 0 gets zeros
        want = xs[grp[0]] if i == 1 else np.zeros_like(xs[r])
        np.testing.assert_array_equal(ranks[r][f"ppermute/{axis}"], want)
        # a shift of 1 around a ring of 2: each index receives the other
        np.testing.assert_array_equal(ranks[r][f"ring_shift/{axis}"],
                                      xs[grp[(i - 1) % len(grp)]])


@pytest.mark.parametrize("axis", AXES)
def test_axis_index_and_size(ranks, axis):
    for r in range(WORLD):
        grp = _group_of(axis, r)
        assert ranks[r][f"axis/{axis}"].tolist() == [grp.index(r), len(grp)]


def test_absent_axis_is_the_identity(ranks):
    xs = _inputs()
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["absent/psum"], xs[r])
        assert ranks[r]["absent/axis"].tolist() == [0, 1]


def _grad_want(name, axis, r, xs):
    """d/dx_r of sum over ranks of sum(w_m * op(x)_m), in numpy."""
    grp = _group_of(axis, r)
    n, i = len(grp), grp.index(r)
    w = {m: _x(m, _out_shape(name, n), salt=7) for m in grp}
    if name == "all_gather":
        return sum(np.split(w[m], n, axis=0)[i] for m in grp)
    if name == "reduce_scatter":
        return np.concatenate([w[m] for m in grp], axis=0)
    if name == "psum":
        return sum(w[m] for m in grp)
    if name == "all_to_all":
        # y_m = concat over k of split(x_k, n, 1)[m] along 0, so x_r's
        # column block m reaches rank m's row block i
        return np.concatenate([np.split(w[m], n, axis=0)[i] for m in grp],
                              axis=1)
    # ring shift by 1: x_r goes to index i + 1
    return w[grp[(i + 1) % n]]


def _out_shape(name, n):
    return {"all_gather": (4 * n, 6), "reduce_scatter": (4 // n, 6),
            "psum": (4, 6), "all_to_all": (4 * n, 6 // n),
            "ppermute": (4, 6)}[name]


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name", ["all_gather", "reduce_scatter", "psum",
                                  "all_to_all", "ppermute"])
def test_gradients_are_the_transposes(ranks, axis, name):
    xs = _inputs()
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"grad/{name}/{axis}"],
                                   _grad_want(name, axis, r, xs), **TOL)


def test_shard_map_runs_the_body_on_shards(ranks):
    gx, gw = _x(0, (8, 4), salt=3), _x(0, (4, 6), salt=4)
    for r in range(WORLD):
        out = ranks[r]
        assert out["shard_map/is_dtensor"]
        np.testing.assert_allclose(out["shard_map/matmul"], gx @ gw, **TOL)
        assert out["shard_map/local_shape"].tolist() == [4, 3]
        np.testing.assert_allclose(out["shard_map/psum"], gx.sum(0), **TOL)


def test_collective_op_counts_use_the_jax_labels(ranks):
    # psum: one allreduce; all_gather: one; Shard(1) -> Shard(0) over
    # tensor: an all-to-all, or on gloo (which has none for the CPU) an
    # all_gather and a chunk
    for r in range(WORLD):
        allreduce, all_gather, reduce_scatter = ranks[r]["counts"].tolist()
        assert allreduce == 1 and reduce_scatter == 0
        assert all_gather >= 1
