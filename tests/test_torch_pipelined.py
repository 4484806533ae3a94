"""The port's pipelined transformer (ray_tpu_torch.models.pipelined)
against the JAX package's, at the default `PipelinedConfig`, in float32
with the same converted parameters, on four gloo ranks of the CPU
against the JAX model on four CPU devices of the same mesh shape:

- `pipelined_loss` and its gradients on (pipe=2, fsdp=2), where the
  blocks' shard_map is manual over every axis (ring attention over
  fsdp, the interleaved schedule over pipe), and on (data=2, pipe=2),
  where ``shard_map(axis_names={"pipe", "fsdp"})`` leaves data
  automatic: loss within 1e-5, gradients within 1e-4 of each leaf's
  largest;
- two `pipelined_train_step`s: losses within 1e-5, params within 1e-4;
- the `stage_apply` chain over the stages of `split_pipeline_stages`
  and of `split_pipeline_stages_interleaved`, with no mesh and with a
  data mesh, equals `pipelined_loss` (the JAX docstring's promise);
- the split and merge helpers round-trip and equal JAX's.

The ranks run in one spawn for the module (test_torch_collectives.py's
`run_ranks`); jax is imported only inside functions of this module."""

import numpy as np
import pytest

from tests.test_torch_collectives import run_ranks

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
MESHES = (("pipe2_fsdp2", {"pipe": 2, "fsdp": 2}),
          ("data2_pipe2", {"data": 2, "pipe": 2}))
BATCH = 8


def _batch(vocab, T, seed=0):
    toks = np.random.RandomState(seed).randint(
        0, vocab, (BATCH, T + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax_params():
    import jax

    from ray_tpu.models import pipelined

    return jax.tree.map(np.asarray, pipelined.init_pipelined(
        jax.random.PRNGKey(0), pipelined.PipelinedConfig()))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _pipelined_body(rank, params):
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import pipelined as pl
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import (
        PartitionSpec as P,
        _prune_spec,
        placements,
    )
    from ray_tpu_torch.util import tree

    cfg = pl.PipelinedConfig()
    b = _batch(cfg.vocab_size, cfg.block_size)
    host = interop.params_from_jax(params)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    out = {}
    for name, shape in MESHES:
        mesh = build_mesh(MeshSpec(**shape), device="cpu")
        shard = pl.pipelined_shardings(host, cfg, mesh)
        dp = tree.unflatten(host, [
            distribute_tensor(t, mesh, s.placements).requires_grad_(True)
            for t, s in zip(tree.leaves(host), tree.leaves(shard))])
        bspec = placements(_prune_spec(P("data"), mesh), mesh)
        batch = {k: distribute_tensor(torch.from_numpy(v), mesh, bspec)
                 for k, v in b.items()}
        loss = pl.pipelined_loss(dp, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, tree.leaves(dp))
        res = {"loss": float(whole(loss).detach()),
               "grads": interop.params_to_numpy(tree.unflatten(
                   host, [whole(g) for g in grads]))}
        step = pl.pipelined_train_step(cfg, mesh)
        p = tree.tree_map(lambda t: t.detach(), dp)
        losses = []
        for _ in range(2):
            p, lo = step(p, batch)
            losses.append(float(whole(lo)))
        res["step_losses"] = losses
        res["step_params"] = interop.params_to_numpy(p)
        res["qkv_local"] = tuple(dp["blocks"]["qkv"].to_local().shape)
        if "data" in shape:
            # stage_apply with a data mesh: the microbatch split over it
            st = pl.split_pipeline_stages(host, cfg, 2)
            h = pl.stage_apply(cfg, st[0], 0, 2,
                               torch.from_numpy(b["tokens"]), mesh=mesh)
            res["chain_data_mesh"] = float(whole(pl.stage_apply(
                cfg, st[1], 1, 2, h, torch.from_numpy(b["targets"]),
                mesh=mesh)))
        out[name] = res
    # the stage chains with no mesh (the one-device fsdp mesh)
    toks, tgts = (torch.from_numpy(b[k]) for k in ("tokens", "targets"))
    chains = {}
    for S in (1, 2, 4):
        st = pl.split_pipeline_stages(host, cfg, S)
        h = toks
        for s in range(S):
            h = pl.stage_apply(cfg, st[s], s, S, h,
                               tgts if s == S - 1 else None)
        chains[f"flat{S}"] = float(h)
    chunks = pl.split_pipeline_stages_interleaved(host, cfg, 2, 2)
    h = toks
    for v in range(4):
        h = pl.stage_apply(cfg, chunks[v % 2][v // 2], v, 4, h,
                           tgts if v == 3 else None)
    chains["interleaved2x2"] = float(h)
    out["chains"] = chains
    return out if rank == 0 else None


def _jax_runs(params):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import pipelined as pl
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    cfg = pl.PipelinedConfig()
    b = _batch(cfg.vocab_size, cfg.block_size)
    out = {}
    for name, shape in MESHES:
        mesh = build_mesh(MeshSpec(**{"data": 1, "tensor": 1, **shape}),
                          devices=jax.devices()[:4])
        p = jax.device_put(jax.tree.map(jnp.asarray, params),
                           pl.pipelined_shardings(params, cfg, mesh))
        batch = jax.device_put(
            {k: jnp.asarray(v, jnp.int32) for k, v in b.items()},
            NamedSharding(mesh, P(("dcn", "data"))))
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda pp, bb: pl.pipelined_loss(pp, bb, cfg, mesh)))(
                p, batch)
            step = pl.pipelined_train_step(cfg, mesh)
            losses = []
            for _ in range(2):
                p, lo = step(p, batch)
                losses.append(float(lo))
        out[name] = {"loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads),
                     "step_losses": losses,
                     "step_params": jax.tree.map(np.asarray, p)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = _jax_params()
    ranks, want = run_ranks(_pipelined_body,
                            tmp_path_factory.mktemp("pipelined"), params,
                            meanwhile=lambda: _jax_runs(params))
    return ranks[0], want


def _assert_tree(got, want, rel, what):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want))) == 8
    for (pg, g), (pw, w) in pairs:
        assert pg == pw and g.shape == w.shape, (what, pg)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max(),
                                   err_msg=f"{what}{pg}")


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_pipelined_loss_matches_jax(runs, name):
    got, want = runs
    np.testing.assert_allclose(got[name]["loss"], want[name]["loss"],
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_pipelined_grads_match_jax(runs, name):
    got, want = runs
    _assert_tree(got[name]["grads"], want[name]["grads"], GRAD_TOL,
                 f"{name} grad")


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_two_train_steps_match_jax(runs, name):
    got, want = runs
    np.testing.assert_allclose(got[name]["step_losses"],
                               want[name]["step_losses"], rtol=LOSS_TOL)
    assert got[name]["step_losses"][1] < got[name]["step_losses"][0]
    _assert_tree(got[name]["step_params"], want[name]["step_params"],
                 GRAD_TOL, f"{name} params")


def test_block_stacks_shard_over_pipe(runs):
    """qkv (V, D, 3D) is P("pipe", None, "tensor"): two of the four
    virtual stages a pipe rank (no tensor axis in either mesh)."""
    got, _ = runs
    for name, _ in MESHES:
        assert got[name]["qkv_local"] == (2, 64, 192)


@pytest.mark.parametrize("chain", ["flat1", "flat2", "flat4",
                                   "interleaved2x2"])
def test_stage_chain_equals_pipelined_loss(runs, chain):
    got, want = runs
    np.testing.assert_allclose(got["chains"][chain],
                               got["pipe2_fsdp2"]["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(got["chains"][chain],
                               want["pipe2_fsdp2"]["loss"], rtol=LOSS_TOL)


def test_stage_chain_on_a_data_mesh_equals_pipelined_loss(runs):
    got, _ = runs
    np.testing.assert_allclose(got["data2_pipe2"]["chain_data_mesh"],
                               got["data2_pipe2"]["loss"], rtol=LOSS_TOL)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_split_merge_round_trip_and_match_jax(S):
    from ray_tpu.models import pipelined as jpl

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import pipelined as pl

    params = _jax_params()
    cfg, jcfg = pl.PipelinedConfig(), jpl.PipelinedConfig()
    host = interop.params_from_jax(params)
    stages = pl.split_pipeline_stages(host, cfg, S)
    want = jpl.split_pipeline_stages(params, jcfg, S)
    assert len(stages) == len(want) == S
    for s, w in zip(stages, want):
        assert sorted(s) == sorted(w)
        for (pg, g), (pw, x) in zip(_leaves(interop.params_to_numpy(s)),
                                    _leaves(w)):
            assert pg == pw
            np.testing.assert_array_equal(g, x)
    merged = interop.params_to_numpy(pl.merge_pipeline_stages(stages))
    for (pg, g), (pw, x) in zip(_leaves(merged), _leaves(params)):
        assert pg == pw
        np.testing.assert_array_equal(g, x)
    with pytest.raises(ValueError):
        pl.split_pipeline_stages(host, cfg, 5)


def test_interleaved_split_merge_round_trip_and_match_jax():
    from ray_tpu.models import pipelined as jpl

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import pipelined as pl

    params = _jax_params()
    host = interop.params_from_jax(params)
    chunks = pl.split_pipeline_stages_interleaved(
        host, pl.PipelinedConfig(), 2, 2)
    want = jpl.split_pipeline_stages_interleaved(
        params, jpl.PipelinedConfig(), 2, 2)
    for row, wrow in zip(chunks, want):
        for c, w in zip(row, wrow):
            for (pg, g), (pw, x) in zip(
                    _leaves(interop.params_to_numpy(c)), _leaves(w)):
                assert pg == pw
                np.testing.assert_array_equal(g, x)
    merged = interop.params_to_numpy(
        pl.merge_pipeline_stages_interleaved(chunks))
    for (_, g), (_, x) in zip(_leaves(merged), _leaves(params)):
        np.testing.assert_array_equal(g, x)
