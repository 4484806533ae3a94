"""The remat policies of the port's GPT-2 (RAY_TPU_REMAT_POLICY "full",
"save_flash", "save_dots", "none") against the JAX model on
GPT2Config.tiny() in float32, with the JAX parameters converted through
ray_tpu_torch.interop: every leaf's gradient under each policy against
``jax.grad`` under the same policy; what the backward's replay runs
(the flash forward again under "full" only; under "save_dots" no matrix
product either, counted with a TorchDispatchMode); and the flash custom
operator those policies see, held to ``torch.library.opcheck``. On the
CPU attention runs the plain versions of K1, K2 and K3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.util import tree

# the tolerances of tests/test_torch_gpt2_train.py
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
POLICIES = ("full", "save_flash", "save_dots", "none")
B, T = 2, 32


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), dtype=torch.float32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp)


def _batch(seed, cfg):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class _OpCount(TorchDispatchMode):
    """Counts the aten (and custom) operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward(params, batch, cfg, monkeypatch):
    """The loss, the grads, and what ran: flash forwards (the plain K1
    on the CPU) in the forward and in the backward, and the operators
    the backward dispatched."""
    calls = []
    plain = t_flash._fwd_plain
    monkeypatch.setattr(t_flash, "_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    leaves = [t.detach().requires_grad_() for t in tree.leaves(params)]
    loss = t_gpt2.gpt2_loss(tree.unflatten(params, leaves),
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, cfg)
    forward = len(calls)
    with _OpCount() as ops:
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(loss.detach()),
            "grads": tree.unflatten(params, grads),
            "flash_forward": forward, "flash_backward": len(calls) - forward,
            "ops": ops.counts}


@pytest.mark.parametrize("policy", POLICIES)
def test_grads_match_jax_under_each_policy(models, monkeypatch, policy):
    """Under each policy the port's grads equal JAX's under the same
    RAY_TPU_REMAT_POLICY; the flash forward runs once a layer in the
    forward, and again in the backward only under "full"."""
    jcfg, tcfg, jp, tp = models
    monkeypatch.setenv("RAY_TPU_REMAT_POLICY", policy)
    batch = _batch(11, tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: jax_gpt2.gpt2_loss(p, jb, jcfg))(jp)
    got = _backward(tp, batch, tcfg, monkeypatch)
    np.testing.assert_allclose(got["loss"], float(want_loss),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    for path, w, g in _pairs(want, got["grads"]):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{policy}{path}")
    L = tcfg.n_layer
    assert got["flash_forward"] == L
    assert got["flash_backward"] == (L if policy == "full" else 0)


def test_save_dots_replays_no_matmul(models, monkeypatch):
    """The backward's matrix products: under "none" only the gradients'
    own; "save_dots" keeps every forward aten.mm/addmm output, so it runs
    exactly as many; "full" and "save_flash" replay the forward's
    products on top. Every policy gives the same grads."""
    _, tcfg, _, tp = models
    batch = _batch(12, tcfg)
    runs = {}
    for policy in POLICIES:
        monkeypatch.setenv("RAY_TPU_REMAT_POLICY", policy)
        runs[policy] = _backward(tp, batch, tcfg, monkeypatch)
    mm = {p: sum(r["ops"].get(op, 0) for op in (torch.ops.aten.mm.default,
                                                torch.ops.aten.addmm.default))
          for p, r in runs.items()}
    assert mm["none"] > 0
    assert mm["save_dots"] == mm["none"]
    assert mm["full"] > mm["none"] and mm["save_flash"] > mm["none"]
    flash = torch.ops.ray_tpu_torch.flash_fwd.default
    assert runs["full"]["ops"].get(flash) == tcfg.n_layer
    for policy in ("save_flash", "save_dots", "none"):
        assert flash not in runs[policy]["ops"], policy
    for policy in POLICIES:
        for a, b in zip(tree.leaves(runs[policy]["grads"]),
                        tree.leaves(runs["none"]["grads"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_policies_save_the_ops_jax_names():
    """save_flash keeps the flash operator's (o, lse), JAX's flash_o and
    flash_lse; save_dots also the 2-D products, JAX's
    dots_with_no_batch_dims; a batched bmm is left to the replay."""
    flash = torch.ops.ray_tpu_torch.flash_fwd.default
    assert t_gpt2._saved_ops("save_flash") == {flash}
    dots = t_gpt2._saved_ops("save_dots")
    assert dots == {flash, torch.ops.aten.mm.default,
                    torch.ops.aten.addmm.default}
    assert torch.ops.aten.bmm.default not in dots


def _pairs(jtree, ttree):
    def walk(j, t, path):
        if isinstance(j, dict):
            for k in sorted(j):
                yield from walk(j[k], t[k], f"{path}/{k}")
        else:
            yield path, np.asarray(j), t.detach().numpy()
    return list(walk(jtree, ttree, ""))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_operator_passes_opcheck(causal):
    """The custom operator on CPU tensors: its schema, fake kernel,
    autograd registration and its use under AOT dispatch, as
    torch.library.opcheck checks them."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 40, 2, 32)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    torch.library.opcheck(t_flash.flash_fwd, (q, k, v, causal, 0.2))


def test_backward_skips_dq_when_q_needs_no_grad(monkeypatch):
    """The operator's backward asks `_bwd` for dq only when q requires
    grad (on the card: no K2 launch), and for dk/dv only when k or v
    does (no K3)."""
    seen = []
    bwd = t_flash._bwd_plain

    def spy(q, k, v, o, lse, do, causal, sm_scale, want_dq, want_dkv):
        seen.append((want_dq, want_dkv))
        return bwd(q, k, v, o, lse, do, causal, sm_scale, want_dq, want_dkv)

    monkeypatch.setattr(t_flash, "_bwd_plain", spy)
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 32)).astype(
        np.float32)) for _ in range(3))
    for need in ((False, True, True), (True, False, False)):
        args = [t.clone().requires_grad_(n) for t, n in zip((q, k, v),
                                                             need)]
        t_flash.flash_attention(*args).sum().backward()
        assert all((a.grad is not None) == n for a, n in zip(args, need))
    assert seen == [(False, True), (True, False)]
