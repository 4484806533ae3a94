"""The port's MoE layer (ray_tpu_torch.models.moe) against the JAX
package's, in float32 with the same converted parameters: `moe_layer`'s
output within 1e-5, its aux loss within rtol 1e-5 and the gradients of
mean(out**2) + 0.01 aux within 1e-4, on one process, with capacity to
spare and with tokens dropped over capacity; and on four gloo ranks at
(data=2, expert=2), experts laid out by `moe_partition_rules` and the
tokens sharded over data, against the JAX layer under jit on four CPU
devices of the same mesh: output within 1e-4, aux within rtol 1e-5
(tests/test_moe.py), and the gradients within 1e-4. Also the shapes and scales of `init_moe` and the
partition rules against JAX's.

The ranks run in one spawn for the module (test_torch_collectives.py's
`run_ranks`); jax is imported only inside functions of this module."""

import numpy as np
import pytest

from tests.test_torch_collectives import run_ranks

OUT_TOL = 1e-5
AUX_RTOL = 1e-5
GRAD_TOL = 1e-4
MESH_TOL = 1e-4
BASE = dict(num_experts=4, top_k=2, d_model=32, d_ff=64,
            capacity_factor=2.0)
# (capacity_factor, top_k): room for every token; 0.5 drops tokens
LOCAL = ((2.0, 2), (0.5, 2), (1.0, 1))


def _jax_params(cfg_kw, seed=0):
    import jax

    from ray_tpu.models import moe

    cfg = moe.MoEConfig(**cfg_kw, dtype=jax.numpy.float32)
    return jax.tree.map(np.asarray, moe.init_moe(jax.random.PRNGKey(seed),
                                                 cfg))


def _x(shape, seed=1):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _jax_layer(params, x, cfg_kw):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe

    cfg = moe.MoEConfig(**cfg_kw, dtype=jnp.float32)

    def loss(p, xx):
        out, aux = moe.moe_layer(p, xx, cfg)
        return jnp.mean(out ** 2) + 0.01 * aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(out), float(aux), jax.tree.map(np.asarray, grads)


def _port_layer(params, x, cfg_kw):
    import torch

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import moe

    cfg = moe.MoEConfig(**cfg_kw, dtype=torch.float32)
    p = interop.params_from_jax(params)
    for t in (p["gate"]["kernel"], p["wi"], p["wo"]):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_layer(p, xt, cfg)
    ((out ** 2).mean() + 0.01 * aux).backward()
    grads = ({"gate": {"kernel": p["gate"]["kernel"].grad.numpy()},
              "wi": p["wi"].grad.numpy(), "wo": p["wo"].grad.numpy()},
             xt.grad.numpy())
    return out.detach().numpy(), float(aux.detach()), grads


@pytest.mark.parametrize("cf,k", LOCAL)
def test_moe_layer_matches_jax(cf, k):
    kw = dict(BASE, capacity_factor=cf, top_k=k)
    params = _jax_params(kw)
    x = _x((2, 16, kw["d_model"]))
    out, aux, (gp, gx) = _port_layer(params, x, kw)
    w_out, w_aux, (wgp, wgx) = _jax_layer(params, x, kw)
    np.testing.assert_allclose(out, w_out, atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(aux, w_aux, rtol=AUX_RTOL)
    for g, w, what in ((gp["gate"]["kernel"], wgp["gate"]["kernel"], "gate"),
                       (gp["wi"], wgp["wi"], "wi"), (gp["wo"], wgp["wo"],
                                                     "wo"), (gx, wgx, "x")):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=what)


def test_moe_drops_tokens_over_capacity():
    """At capacity_factor 0.5 some tokens reach no expert: their output
    rows are zero on both sides."""
    kw = dict(BASE, capacity_factor=0.5)
    params = _jax_params(kw)
    x = _x((2, 16, kw["d_model"]))
    out, _, _ = _port_layer(params, x, kw)
    zero = np.all(out.reshape(-1, kw["d_model"]) == 0.0, axis=-1)
    assert zero.any()
    w_out = _jax_layer(params, x, kw)[0].reshape(-1, kw["d_model"])
    assert np.array_equal(zero, np.all(w_out == 0.0, axis=-1))


def test_init_and_rules_match_jax():
    import jax
    import torch

    from ray_tpu.models import moe as jmoe
    from ray_tpu_torch.models import moe

    cfg = moe.MoEConfig(**BASE)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = _jax_params(BASE)
    assert p["gate"]["kernel"].shape == want["gate"]["kernel"].shape
    for k in ("wi", "wo"):
        assert tuple(p[k].shape) == want[k].shape
        np.testing.assert_allclose(p[k].std().item(), want[k].std(),
                                   rtol=0.05)
    assert [(r, tuple(s)) for r, s in moe.moe_partition_rules()] == \
        [(r, tuple(s)) for r, s in jmoe.moe_partition_rules()]
    assert moe.MoEConfig().dtype == torch.bfloat16 and \
        jmoe.MoEConfig().dtype == jax.numpy.bfloat16


MESH = {"data": 2, "expert": 2}
MESH_KW = dict(BASE, num_experts=8)
MESH_X = (4, 16, 32)


def _moe_mesh_body(rank, params):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import (
        PartitionRules,
        PartitionSpec as P,
        placements,
        shard_pytree,
    )

    mesh = build_mesh(MeshSpec(**MESH), device="cpu")
    cfg = moe.MoEConfig(**MESH_KW, dtype=torch.float32)
    p = shard_pytree({"moe": interop.params_from_jax(params)},
                     PartitionRules(moe.moe_partition_rules()), mesh)["moe"]
    x = distribute_tensor(torch.from_numpy(_x(MESH_X)), mesh,
                          placements(P("data"), mesh))
    leaves = [p["gate"]["kernel"], p["wi"], p["wo"]]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = moe.moe_layer(p, x, cfg)
    grads = torch.autograd.grad((out ** 2).mean() + 0.01 * aux, leaves)
    return {"out": out.full_tensor().detach().numpy(),
            "aux": float(aux.full_tensor()),
            "grads": [g.full_tensor().numpy() for g in grads],
            "wi_local": tuple(p["wi"].to_local().shape)}


def _jax_mesh():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import moe
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(**MESH, tensor=1), devices=jax.devices()[:4])
    cfg = moe.MoEConfig(**MESH_KW, dtype=jnp.float32)
    params = _jax_params(MESH_KW)
    with mesh:
        sp = {"gate": {"kernel": jax.device_put(
            params["gate"]["kernel"], NamedSharding(mesh, P()))},
            "wi": jax.device_put(params["wi"],
                                 NamedSharding(mesh, P("expert"))),
            "wo": jax.device_put(params["wo"],
                                 NamedSharding(mesh, P("expert")))}
        xs = jax.device_put(_x(MESH_X), NamedSharding(mesh, P("data")))
        out, aux = jax.jit(lambda p, xx: moe.moe_layer(p, xx, cfg))(sp, xs)

        def loss(p):
            o, a = moe.moe_layer(p, xs, cfg)
            return jnp.mean(o ** 2) + 0.01 * a

        g = jax.jit(jax.grad(loss))(sp)
    return {"out": np.asarray(out), "aux": float(aux),
            "grads": [np.asarray(g["gate"]["kernel"]), np.asarray(g["wi"]),
                      np.asarray(g["wo"])]}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    params = _jax_params(MESH_KW)
    ranks, want = run_ranks(_moe_mesh_body, tmp_path_factory.mktemp("moe"),
                            params, meanwhile=_jax_mesh)
    return ranks, want


def test_moe_on_data_expert_mesh_matches_jax(mesh_runs):
    ranks, want = mesh_runs
    for r in ranks:
        np.testing.assert_allclose(r["out"], want["out"], atol=MESH_TOL,
                                   rtol=MESH_TOL)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=AUX_RTOL)


def test_moe_gradients_on_data_expert_mesh_match_jax(mesh_runs):
    """The gradients of mean(out**2) + 0.01 aux with respect to the gate
    and the expert-sharded kernels, through top-k's gathered values, on
    every rank, within 1e-4 of JAX's on the same mesh."""
    ranks, want = mesh_runs
    for r in ranks:
        for g, w, what in zip(r["grads"], want["grads"],
                              ("gate", "wi", "wo")):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=what)


def test_moe_experts_shard_over_the_expert_axis(mesh_runs):
    ranks, _ = mesh_runs
    E, Dm, Df = MESH_KW["num_experts"], MESH_KW["d_model"], MESH_KW["d_ff"]
    assert all(r["wi_local"] == (E // 2, Dm, Df) for r in ranks)
