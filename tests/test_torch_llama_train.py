"""The port's Llama training path (ray_tpu_torch.models.llama
`llama_forward`, `llama_loss`, ray_tpu_torch.train) against the JAX
package on LlamaConfig.tiny() (float32, H=4 query heads over H_kv=2 KV
heads), with the JAX parameters converted through ray_tpu_torch.interop:
the loss and every leaf's gradient against
``jax.value_and_grad(llama_loss)``, remat on against off, the
grouped-query gradient's head order, and three AdamW steps of
`make_train_step` against the JAX steps. On the CPU attention runs the
plain versions of K1, K2 and K3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.models as jax_models
from ray_tpu.models import llama as jax_llama
from ray_tpu.train import spmd as jax_spmd
from ray_tpu_torch import interop
from ray_tpu_torch import models as t_models
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.train import optim as t_optim
from ray_tpu_torch.train import spmd as t_spmd
from ray_tpu_torch.util import tree

# the tolerances of tests/test_torch_gpt2_train.py
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
TRAJ_TOL = 1e-4
ADAM_PARAM_ATOL = 1e-3  # Adam's first step turns near-zero grads into +-lr
UPDATE_RTOL = 1e-3  # the first update's error over its norm, by leaf
ADAM_STEPS = 3
B, T = 2, 32


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny()
    tcfg = t_llama.LlamaConfig.tiny()
    jp = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp)


def _batch(seed, cfg):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pairs(jtree, ttree):
    """(path, jax leaf as numpy, torch leaf as numpy) in one order."""
    def walk(j, t, path):
        if isinstance(j, dict):
            for k in sorted(j):
                yield from walk(j[k], t[k], f"{path}/{k}")
        else:
            yield path, np.asarray(j), t.detach().numpy()
    return list(walk(jtree, ttree, ""))


def _port_grads(params, batch, cfg):
    leaves = [t.detach().requires_grad_() for t in tree.leaves(params)]
    loss = t_llama.llama_loss(tree.unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, grads)


def _jax_grads(params, batch, cfg):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(
        lambda p: jax_llama.llama_loss(p, jb, cfg))(params)


def _swap_kv_heads(jp, head_dim):
    """The JAX tree with its two KV heads' projections swapped."""
    swapped = {**jp, "blocks": dict(jp["blocks"])}
    for name in ("wk", "wv"):
        w = np.asarray(jp["blocks"][name])
        swapped["blocks"][name] = np.concatenate(
            [w[..., head_dim:], w[..., :head_dim]], axis=-1)
    return swapped


def test_models_package_exports_llama_training_as_jax_does():
    assert {"llama_forward", "llama_loss", "init_llama",
            "LlamaConfig"} <= set(t_models.__all__)
    assert set(t_models.__all__) <= set(jax_models.__all__)
    assert t_models.llama_loss is t_llama.llama_loss


def test_loss_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    batch = _batch(1, tcfg)
    want = float(jax_llama.llama_loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = float(t_llama.llama_loss(tp, _torch(batch), tcfg))
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)


def test_grads_match_jax_per_leaf(models):
    jcfg, tcfg, jp, tp = models
    batch = _batch(2, tcfg)
    want_loss, want = _jax_grads(jp, batch, jcfg)
    loss, got = _port_grads(tp, _torch(batch), tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    pairs = _pairs(want, got)
    assert len(pairs) == len(tree.leaves(tp))
    for path, w, g in pairs:
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=path)


def test_remat_recomputes_the_forward_and_keeps_the_grads(models,
                                                          monkeypatch):
    """Remat on runs each block's forward again in the backward, so the
    flash forward runs 2 L times per step against L without; the grads
    are the same. (Llama tiny turns remat off, as in JAX.)"""
    _, tcfg, _, tp = models
    assert not tcfg.remat
    calls = []
    plain = t_flash._fwd_plain
    monkeypatch.setattr(t_flash, "_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    batch = _torch(_batch(3, tcfg))
    results = {}
    for remat in (True, False):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        results[remat] = _port_grads(tp, batch, cfg)
        assert len(calls) == (2 if remat else 1) * tcfg.n_layer
    for a, b in zip(tree.leaves(results[True][1]),
                    tree.leaves(results[False][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert float(results[True][0]) == pytest.approx(
        float(results[False][0]), abs=1e-6)


def test_remat_is_off_without_grad(models, monkeypatch):
    """Under no_grad the forward runs each block once, remat or not."""
    _, tcfg, _, tp = models
    calls = []
    plain = t_flash._fwd_plain
    monkeypatch.setattr(t_flash, "_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    cfg = dataclasses.replace(tcfg, remat=True)
    with torch.no_grad():
        t_llama.llama_loss(tp, _torch(_batch(4, tcfg)), cfg)
    assert len(calls) == tcfg.n_layer


def test_gqa_grads_follow_the_jnp_repeat_head_order(models):
    """Query heads 0, 1 read KV head 0 and heads 2, 3 KV head 1, and the
    backward sums each group's dk/dv through repeat_interleave: with
    the two KV heads' projections swapped the loss changes, and the
    grads still match JAX's leaf by leaf (a tiled .repeat would pair
    heads 0, 2 and give other grads)."""
    jcfg, tcfg, jp, _ = models
    assert (tcfg.n_head, tcfg.n_kv_head) == (4, 2)
    batch = _batch(5, tcfg)
    losses = []
    for params in (jp, _swap_kv_heads(jp, tcfg.head_dim)):
        want_loss, want = _jax_grads(params, batch, jcfg)
        loss, got = _port_grads(interop.params_from_jax(params),
                                _torch(batch), tcfg)
        np.testing.assert_allclose(float(loss), float(want_loss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for path, w, g in _pairs(want, got):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=path)
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) > 1e-4


def test_adamw_step_matches_jax_step(models):
    """ADAM_STEPS `make_train_step` AdamW steps on Llama tiny against the
    JAX steps from the same params and batch: every step's loss and grad
    norm at TRAJ_TOL (the later ones are taken after the updates), the
    first update p1 - p0 leaf by leaf within UPDATE_RTOL of JAX's in
    norm, and the updated params within Adam's first-step sign flips."""
    jcfg, tcfg, jp, tp = models
    jtx = optax.adamw(3e-4, weight_decay=0.1)
    ttx = t_optim.adamw(3e-4, weight_decay=0.1)
    jstate = jax_spmd.TrainState.create(jp, jtx)
    jstep = jax_spmd.make_train_step(
        lambda p, b: jax_llama.llama_loss(p, b, jcfg), jtx, donate=False)
    tstate = t_spmd.TrainState.create(tree.tree_map(lambda t: t.clone(),
                                                    tp), ttx)
    tstep = t_spmd.make_train_step(
        lambda p, b: t_llama.llama_loss(p, b, tcfg), ttx)
    batch = _batch(6, tcfg)
    got, want = [], []
    for i in range(ADAM_STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        tstate, tm = tstep(tstate, batch)
        got.append([float(tm["loss"]), float(tm["grad_norm"])])
        want.append([float(jm["loss"]), float(jm["grad_norm"])])
        if i == 0:
            for path, w, g in _pairs(jstate.params, tstate.params):
                np.testing.assert_allclose(g, w, atol=ADAM_PARAM_ATOL,
                                           err_msg=path)
            for (path, w0, g0), (_, w1, g1) in zip(
                    _pairs(jp, tp), _pairs(jstate.params, tstate.params)):
                dw, dg = w1 - w0, g1 - g0
                assert np.linalg.norm(dg - dw) <= UPDATE_RTOL * \
                    np.linalg.norm(dw), path
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    assert tstate.step == ADAM_STEPS
    # the steps moved the loss far past the tolerance
    assert got[0][0] - got[-1][0] > 100 * TRAJ_TOL
