"""Host collectives of the port (``ray_tpu_torch.util.collective``)
against the JAX package's ``ray_tpu.util.collective``.

- The six host cases of tests/test_collective.py (allreduce, allgather,
  broadcast, reducescatter, send/recv, a pytree allreduce from tasks),
  with their own inputs and assertions, on the port's local mode and
  again on its cluster runtime (one module-scoped runtime of each).
- The reducers against JAX's ``_REDUCERS`` on seeded nested dict, list
  and tuple trees, for all five ops, with numpy leaves and with torch
  leaves: the results are equal, element for element.
- `reducescatter`'s shards of an uneven length against JAX's
  ``np.array_split``.
- Tensor leaves: what comes back is a tensor, on the device of the
  caller's own leaf; a non-root rank that passes None to `broadcast`
  gets the root's tensor on the host.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray_tpu
from ray_tpu.util import collective as jcol
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import collective as col


@pytest.fixture(scope="module", params=["local", "cluster"])
def ray_rt(request):
    c = None
    if request.param == "local":
        ray_tpu.init(local_mode=True, num_cpus=8)
    else:
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
        c.wait_for_nodes()
        ray_tpu.init(address=c.address)
    try:
        yield request.param
    finally:
        ray_tpu.shutdown()
        if c is not None:
            c.shutdown()
        col._groups.clear()


@ray_tpu.remote(num_cpus=0.2)
class Member:
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def setup(self, group):
        col.init_collective_group(self.world, self.rank, group_name=group)
        return True

    def do_allreduce(self, group):
        x = np.full((4,), float(self.rank + 1))
        return col.allreduce(x, group_name=group)

    def do_allgather(self, group):
        return col.allgather(np.array([self.rank]), group_name=group)

    def do_broadcast(self, group):
        x = np.arange(3.0) if self.rank == 0 else None
        return col.broadcast(x, src_rank=0, group_name=group)

    def do_reducescatter(self, group):
        x = np.arange(8.0)
        return col.reducescatter(x, group_name=group)

    def do_sendrecv(self, group):
        if self.rank == 0:
            col.send(np.array([42.0]), dst_rank=1, group_name=group)
            return None
        return col.recv(src_rank=0, group_name=group)

    def do_tensor_ops(self, group, n):
        """Tensor leaves through every kind: what comes back, and its
        type and device."""
        import torch

        mine = {"w": torch.full((2, 3), float(self.rank + 1)),
                "b": [torch.arange(n, dtype=torch.float32) * (self.rank + 1)]}
        out = {"allreduce": col.allreduce(mine, group_name=group,
                                          op=col.ReduceOp.MEAN),
               "allgather": col.allgather(mine["w"], group_name=group),
               "reducescatter": col.reducescatter(mine["b"][0],
                                                  group_name=group),
               "broadcast": col.broadcast(
                   mine["w"] if self.rank == 0 else None, src_rank=0,
                   group_name=group)}
        col.barrier(group)
        return out


def _mk_group(n, group):
    members = [Member.remote(i, n) for i in range(n)]
    ray_tpu.get([m.setup.remote(group) for m in members], timeout=60)
    return members


def _group_name(rt, base):
    return f"{base}_{rt}"


def _kill(ms):
    for m in ms:
        ray_tpu.kill(m)


# -------------------------------------------------- tests/test_collective.py


def test_allreduce_sum(ray_rt):
    g = _group_name(ray_rt, "g1")
    ms = _mk_group(4, g)
    try:
        outs = ray_tpu.get([m.do_allreduce.remote(g) for m in ms],
                           timeout=60)
        for o in outs:
            assert np.array_equal(o, np.full((4,), 1.0 + 2 + 3 + 4))
    finally:
        _kill(ms)


def test_allgather(ray_rt):
    g = _group_name(ray_rt, "g2")
    ms = _mk_group(3, g)
    try:
        outs = ray_tpu.get([m.do_allgather.remote(g) for m in ms],
                           timeout=60)
        for o in outs:
            assert [int(x[0]) for x in o] == [0, 1, 2]
    finally:
        _kill(ms)


def test_broadcast(ray_rt):
    g = _group_name(ray_rt, "g3")
    ms = _mk_group(3, g)
    try:
        outs = ray_tpu.get([m.do_broadcast.remote(g) for m in ms],
                           timeout=60)
        for o in outs:
            assert np.array_equal(o, np.arange(3.0))
    finally:
        _kill(ms)


def test_reducescatter(ray_rt):
    g = _group_name(ray_rt, "g4")
    ms = _mk_group(2, g)
    try:
        outs = ray_tpu.get([m.do_reducescatter.remote(g) for m in ms],
                           timeout=60)
        # sum over 2 ranks of arange(8) = 2*arange(8); rank i gets half i
        assert np.array_equal(outs[0], 2 * np.arange(4.0))
        assert np.array_equal(outs[1], 2 * np.arange(4.0, 8.0))
    finally:
        _kill(ms)


def test_send_recv(ray_rt):
    g = _group_name(ray_rt, "g5")
    ms = _mk_group(2, g)
    try:
        outs = ray_tpu.get([m.do_sendrecv.remote(g) for m in ms],
                           timeout=60)
        assert outs[0] is None
        assert np.array_equal(outs[1], np.array([42.0]))
    finally:
        _kill(ms)


def test_allreduce_pytree(ray_rt):
    g = _group_name(ray_rt, "g6")
    ms = _mk_group(2, g)
    gt = _group_name(ray_rt, "g6t")

    @ray_tpu.remote(num_cpus=0.2)
    def member_tree(rank, group):
        import numpy as np

        from ray_tpu_torch.util import collective as col

        col.init_collective_group(2, rank, group_name=group)
        tree = {"w": np.ones((2, 2)) * (rank + 1), "b": np.array([rank])}
        return col.allreduce(tree, group_name=group)

    try:
        outs = ray_tpu.get([member_tree.remote(i, gt) for i in range(2)],
                           timeout=60)
        for o in outs:
            assert np.array_equal(o["w"], np.full((2, 2), 3.0))
            assert np.array_equal(o["b"], np.array([1]))
    finally:
        _kill(ms)


# ------------------------------------------------------ tensors and shards


def test_tensor_leaves_come_back_as_tensors(ray_rt):
    """Every kind on torch leaves (a 7-long vector split over 3 ranks):
    the results are tensors on the callers' device and equal the numpy
    reference; reducescatter's shards are JAX's array_split chunks."""
    g = _group_name(ray_rt, "g7")
    n, world = 7, 3
    ms = _mk_group(world, g)
    try:
        outs = ray_tpu.get([m.do_tensor_ops.remote(g, n) for m in ms],
                           timeout=60)
    finally:
        _kill(ms)
    ranks = np.arange(1, world + 1, dtype=np.float32)
    b_sum = sum(np.arange(n, dtype=np.float32) * r for r in ranks)
    shards = np.array_split(b_sum, world, axis=0)
    for rank, o in enumerate(outs):
        ar = o["allreduce"]
        assert isinstance(ar["w"], torch.Tensor) and \
            isinstance(ar["b"], list)
        assert ar["w"].device.type == "cpu"
        want_w = np.full((2, 3), ranks.sum(), np.float32) * np.float32(
            1.0 / world)
        np.testing.assert_array_equal(ar["w"].numpy(), want_w)
        np.testing.assert_array_equal(
            ar["b"][0].numpy(), b_sum * np.float32(1.0 / world))
        assert [t.dtype for t in o["allgather"]] == [torch.float32] * world
        for r, t in enumerate(o["allgather"]):
            np.testing.assert_array_equal(t.numpy(),
                                          np.full((2, 3), float(r + 1)))
        rs = o["reducescatter"]
        assert isinstance(rs, torch.Tensor)
        np.testing.assert_array_equal(rs.numpy(), shards[rank])
        assert isinstance(o["broadcast"], torch.Tensor)
        np.testing.assert_array_equal(o["broadcast"].numpy(),
                                      np.full((2, 3), 1.0))


def _seeded_tree(rng, torch_leaves: bool, dtype):
    def leaf(shape):
        x = rng.standard_normal(shape).astype(dtype)
        if np.issubdtype(dtype, np.integer):
            x = rng.integers(-5, 6, shape).astype(dtype)
        return torch.from_numpy(x) if torch_leaves else x

    return {"a": leaf((3, 4)),
            "b": [leaf((5,)), (leaf((2, 2)), leaf((1,)))],
            "c": {"d": leaf((7,))}}


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _assert_same_tree(got, want, torch_leaves):
    if isinstance(want, dict):
        assert type(got) is dict
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k], torch_leaves)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w, torch_leaves)
    else:
        if torch_leaves:
            assert isinstance(got, torch.Tensor)
            got = got.numpy()
        else:
            assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


OPS = ["sum", "product", "min", "max", "mean"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reducers_match_jax(op, leaves, dtype):
    """The port's reducers against the JAX package's on three members'
    seeded trees: the same structure and the same bits."""
    rng = np.random.default_rng(7)
    torch_leaves = leaves == "torch"
    trees = [_seeded_tree(rng, torch_leaves, np.dtype(dtype))
             for _ in range(3)]
    got = col._REDUCERS[op](trees)
    want = jcol._REDUCERS[op]([_as_numpy(t) for t in trees])
    _assert_same_tree(got, want, torch_leaves)


@pytest.mark.parametrize("op", ["sum", "product", "min", "max"])
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_reducers_match_jax_on_integers(op, leaves):
    """Integer leaves keep their type through the four exact ops."""
    rng = np.random.default_rng(11)
    torch_leaves = leaves == "torch"
    trees = [_seeded_tree(rng, torch_leaves, np.dtype("int64"))
             for _ in range(4)]
    got = col._REDUCERS[op](trees)
    want = jcol._REDUCERS[op]([_as_numpy(t) for t in trees])
    _assert_same_tree(got, want, torch_leaves)


@pytest.mark.parametrize("n,world", [(7, 2), (7, 3), (10, 4), (2, 3)])
def test_reducescatter_shards_match_array_split(n, world):
    """torch.tensor_split gives numpy's array_split chunks along axis 0,
    uneven lengths included."""
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    want = np.array_split(x, world, axis=0)
    got = torch.tensor_split(torch.from_numpy(x), world, dim=0)
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_results_land_on_the_callers_device():
    """A result's tensor leaf goes to the device of the caller's own
    leaf in the same place of its tree; a leaf the caller did not hold
    as a tensor (None, numpy) stays where it arrived."""
    result = {"w": torch.ones(2), "b": [torch.zeros(3), np.ones(1)]}
    mine = {"w": torch.empty(2, device="meta"),
            "b": [torch.empty(3), np.ones(1)]}
    out = col._like(result, mine)
    assert out["w"].device.type == "meta"
    assert out["b"][0].device.type == "cpu"
    assert isinstance(out["b"][1], np.ndarray)
    assert col._like(torch.ones(2), None).device.type == "cpu"
    host = col._to_host({"x": torch.ones(2), "y": [np.ones(1), None]})
    assert host["x"].device.type == "cpu" and host["y"][1] is None
