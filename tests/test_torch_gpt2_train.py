"""The port's training path (ray_tpu_torch.models.gpt2 `gpt2_loss`,
ray_tpu_torch.train) against the JAX package on GPT2Config.tiny() in
float32, with the JAX parameters converted through ray_tpu_torch.interop:
the loss, per-leaf gradients, remat, the optimizers against optax, and
multi-step loss trajectories of `make_train_step` against the JAX step.
On the CPU attention's backward is the plain version of K2 and K3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.train import spmd as jax_spmd
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.ops import paged_attention as t_paged
from ray_tpu_torch.train import optim as t_optim
from ray_tpu_torch.train import spmd as t_spmd
from ray_tpu_torch.util import metrics as t_metrics
from ray_tpu_torch.util import tree

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
TRAJ_TOL = 1e-4
ADAM_PARAM_ATOL = 1e-3  # Adam's first step turns near-zero grads into +-lr
B, T = 2, 32


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), dtype=torch.float32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp)


def _batch(seed, cfg, weights=False):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if weights:
        out["weights"] = (rng.rand(B, T) < 0.7).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _clone(params):
    return tree.tree_map(lambda t: t.clone(), params)


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
    loss = t_gpt2.gpt2_loss(tree.unflatten(params, leaves), batch, cfg)
    return loss, tree.unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("weights", [False, True])
def test_loss_matches_jax(models, weights):
    jcfg, tcfg, jp, tp = models
    batch = _batch(1 + weights, jcfg, weights)
    want = float(jax_gpt2.gpt2_loss(jp, _jax(batch), jcfg))
    got = t_gpt2.gpt2_loss(tp, _torch(batch), tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, atol=LOSS_TOL,
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("weights", [False, True])
def test_grads_match_jax_per_leaf(models, weights):
    jcfg, tcfg, jp, tp = models
    batch = _batch(3 + weights, jcfg, weights)
    want = jax.grad(jax_gpt2.gpt2_loss)(jp, _jax(batch), jcfg)
    _, got = _port_grads(tp, _torch(batch), tcfg)
    pairs = _pairs(want, got)
    assert len(pairs) == 16
    for path, w, g in pairs:
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=path)


def test_remat_recomputes_the_forward_and_keeps_the_grads(models,
                                                          monkeypatch):
    """Remat on (the default) runs each block's forward again in the
    backward, so attention's forward runs 2 L times per step against L
    without; the grads are the same."""
    _, tcfg, _, tp = models
    calls = []
    plain = t_flash._fwd_plain
    monkeypatch.setattr(t_flash, "_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    batch = _torch(_batch(5, tcfg))
    results = {}
    for remat in (True, False):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        results[remat] = _port_grads(tp, batch, cfg)
        assert len(calls) == (2 if remat else 1) * tcfg.n_layer
    for a, b in zip(tree.leaves(results[True][1]),
                    tree.leaves(results[False][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert float(results[True][0].detach()) == pytest.approx(
        float(results[False][0].detach()), abs=1e-6)


def test_remat_policy_none_keeps_activations(models, monkeypatch):
    _, tcfg, _, tp = models
    monkeypatch.setenv("RAY_TPU_REMAT_POLICY", "none")
    calls = []
    plain = t_flash._fwd_plain
    monkeypatch.setattr(t_flash, "_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    _port_grads(tp, _torch(_batch(7, tcfg)), tcfg)
    assert len(calls) == tcfg.n_layer


def test_count_params_matches_jax(models):
    _, _, jp, tp = models
    assert t_gpt2.count_params(tp) == jax_gpt2.count_params(jp)


def _random_tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"x": rng.normal(size=(3,)).astype(np.float32),
                  "y": np.zeros((2,), np.float32)}}


@pytest.mark.parametrize("name,jax_tx,port_tx", [
    ("adamw", optax.adamw(3e-2, weight_decay=0.1),
     t_optim.adamw(3e-2, weight_decay=0.1)),
    ("adamw-defaults", optax.adamw(1e-2), t_optim.adamw(1e-2)),
    ("sgd", optax.sgd(0.1), t_optim.sgd(0.1)),
    ("sgd-momentum", optax.sgd(0.1, momentum=0.9),
     t_optim.sgd(0.1, momentum=0.9)),
])
def test_optimizer_matches_optax(name, jax_tx, port_tx):
    """Three updates on one tree, fed the same grads: the port's
    optimizers against optax (f32, summation-free, so tight)."""
    p0 = _random_tree(0)
    jp = {k: jax.tree.map(jnp.asarray, v) for k, v in p0.items()}
    tp = interop.params_from_jax(p0)
    js, ts = jax_tx.init(jp), port_tx.init(tp)
    for i in range(3):
        g = _random_tree(10 + i)
        upd, js = jax_tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = port_tx.update(interop.params_from_jax(g), ts, tp)
    for path, w, got in _pairs(jp, tp):
        np.testing.assert_allclose(got, w, atol=1e-6, rtol=1e-6,
                                   err_msg=f"{name}{path}")


def _trajectories(models, jax_tx, port_tx, steps=5, accum_steps=1,
                  seeds=None):
    jcfg, tcfg, jp, tp = models
    seeds = seeds or list(range(20, 20 + steps))
    jstate = jax_spmd.TrainState.create(jp, jax_tx,
                                        grad_accum=accum_steps > 1)
    jstep = jax_spmd.make_train_step(
        lambda p, b: jax_gpt2.gpt2_loss(p, b, jcfg), jax_tx, donate=False,
        accum_steps=accum_steps)
    tstate = t_spmd.TrainState.create(_clone(tp), port_tx,
                                      grad_accum=accum_steps > 1)
    tstep = t_spmd.make_train_step(
        lambda p, b: t_gpt2.gpt2_loss(p, b, tcfg), port_tx,
        accum_steps=accum_steps)
    jl, tl = [], []
    for s in seeds:
        batch = _batch(s, jcfg)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, batch)  # numpy leaves move in the step
        jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        tl.append((float(tm["loss"]), float(tm["grad_norm"])))
    assert tstate.step == len(seeds)
    return np.array(jl), np.array(tl), jstate, tstate


def test_sgd_trajectory_matches_jax_step(models):
    jl, tl, js, ts = _trajectories(models, optax.sgd(0.1), t_optim.sgd(0.1))
    np.testing.assert_allclose(tl, jl, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    for path, w, g in _pairs(js.params, ts.params):
        np.testing.assert_allclose(g, w, atol=TRAJ_TOL, err_msg=path)


def test_adamw_trajectory_matches_jax_step(models):
    jl, tl, js, ts = _trajectories(
        models, optax.adamw(3e-4, weight_decay=0.1),
        t_optim.adamw(3e-4, weight_decay=0.1), seeds=[30] * 5)
    np.testing.assert_allclose(tl, jl, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    assert tl[-1, 0] < tl[0, 0]  # one fixed batch: the loss falls
    assert ts.opt_state.count == 5
    for path, w, g in _pairs(js.params, ts.params):
        np.testing.assert_allclose(g, w, atol=ADAM_PARAM_ATOL, err_msg=path)


def test_grad_accumulation_matches_jax_step(models):
    jl, tl, js, ts = _trajectories(
        models, optax.sgd(0.1, momentum=0.9),
        t_optim.sgd(0.1, momentum=0.9), accum_steps=2,
        seeds=[40, 41, 42, 43])
    np.testing.assert_allclose(tl, jl, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    for path, w, g in _pairs(js.params, ts.params):
        np.testing.assert_allclose(g, w, atol=TRAJ_TOL, err_msg=path)
    for leaf in tree.leaves(ts.grad_accum):  # reset on the boundary
        assert not leaf.any()


def test_accumulation_needs_its_buffer(models):
    _, tcfg, _, tp = models
    tx = t_optim.sgd(0.1)
    step = t_spmd.make_train_step(
        lambda p, b: t_gpt2.gpt2_loss(p, b, tcfg), tx, accum_steps=2)
    with pytest.raises(ValueError, match="grad_accum=True"):
        step(t_spmd.TrainState.create(_clone(tp), tx), _batch(44, tcfg))


def test_step_metrics_stay_tensors_and_feed_the_histogram(models):
    _, tcfg, _, tp = models
    tx = t_optim.sgd(0.01)
    step = t_spmd.make_train_step(
        lambda p, b: t_gpt2.gpt2_loss(p, b, tcfg), tx)
    hist = next(m for m in t_metrics._registry.collect()
                if m.name == "train_step_seconds")
    before = sum(hist._totals.values())
    state, m = step(t_spmd.TrainState.create(_clone(tp), tx),
                    _torch(_batch(50, tcfg)))
    assert isinstance(m["loss"], torch.Tensor) and m["loss"].shape == ()
    assert isinstance(m["grad_norm"], torch.Tensor)
    assert float(m["grad_norm"]) > 0 and state.step == 1
    assert sum(hist._totals.values()) == before + 1


def test_step_waterfall_attributes_phases(models):
    _, tcfg, _, tp = models
    tx = t_optim.sgd(0.01)
    step = t_spmd.make_train_step(
        lambda p, b: t_gpt2.gpt2_loss(p, b, tcfg), tx)
    state = t_spmd.TrainState.create(_clone(tp), tx)
    t_spmd.waterfall.reset()
    t_spmd.enable_step_waterfall(True)
    try:
        for s in (60, 61):
            with t_spmd.data_wait():
                batch = _batch(s, tcfg)
            state, _ = step(state, batch)
        summary = t_spmd.waterfall.summary()
    finally:
        t_spmd.enable_step_waterfall(False)
        t_spmd.waterfall.reset()
    assert summary["steps"] == 2
    assert set(summary["phases"]) <= {"data_wait", "h2d", "host", "compute"}
    assert summary["phases"]["compute"] > 0
    assert "host" in summary["phases"]  # the gap before the second step


@pytest.mark.parametrize("kwargs,match", [
    ({"zero_stage": 1}, "needs mesh= and rules="),
    ({"zero_stage": 3, "mesh": object()}, "needs mesh= and rules="),
    ({"shard_optimizer": True}, "needs mesh= and rules="),
    ({"zero_stage": 4}, "zero_stage must be 0|1|2|3"),
    ({"accum_steps": 0}, "accum_steps must be >= 1")])
def test_train_step_refuses_what_jax_refuses(kwargs, match):
    """The JAX step's ValueErrors (ray_tpu/train/spmd.py make_train_step):
    a ZeRO stage without the mesh and rules that derive its layouts, a
    stage off the ladder, no microsteps."""
    for make in (t_spmd.make_train_step, jax_spmd.make_train_step):
        with pytest.raises(ValueError, match=match):
            make(lambda p, b: 0.0, optax.sgd(0.1) if make is
                 jax_spmd.make_train_step else t_optim.sgd(0.1), **kwargs)


def test_paged_attention_refuses_grad():
    """paged_attention has no backward: under grad with an operand that
    requires grad it raises instead of returning a detached result."""
    S, W, H, D, bs = 1, 1, 2, 64, 8
    rng = np.random.RandomState(70)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q = t(S, W, H, D).requires_grad_()
    args = (q, t(S, W, H, D), t(S, W, H, D), t(3, bs, H, D), t(3, bs, H, D),
            torch.tensor([[1, 2]], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no backward"):
        t_paged.paged_attention(*args)
    with torch.no_grad():
        out = t_paged.paged_attention(*args)
    assert out.shape == (S, W, H, D)
