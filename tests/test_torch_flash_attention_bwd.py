"""The port's flash-attention backward (ray_tpu_torch.ops.flash_attention)
against the JAX package: `_bwd_plain` against the Pallas backward kernels
in interpret mode, and the autograd Function's gradients against
``jax.grad`` through the JAX flash attention and the einsum reference,
on the same seeded numpy inputs. On the CPU the port's wrappers run
their plain versions; the CUDA kernels K2 and K3 are held against
`_bwd_plain` on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu.ops.attention import causal_attention_reference as jax_ref
from ray_tpu_torch.ops import attention as t_attention
from ray_tpu_torch.ops import flash_attention as t_flash

# the JAX package's own gradient tolerance (tests/test_flash_attention.py)
ATOL, RTOL = 5e-5, 5e-4
BF16_TOL = 3e-2


def _arrays(seed, n, B, T, H, D):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(n)]


def _to_bh(x):
    B, T, H, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, D)


def _from_bh(x, B, H):
    BH, T, D = x.shape
    return np.array(x, np.float32).reshape(B, H, T, D).transpose(
        0, 2, 1, 3)


def _jax_bwd(q, k, v, do, causal, dtype, sm_scale=None):
    """JAX `_fwd` then `_bwd` (interpret mode, blocks of 64) on (B, T, H,
    D) inputs cast to `dtype`: returns o and lse in the port's layouts
    and (dq, dk, dv) as f32 numpy (B, T, H, D)."""
    B, T, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(D)
    cfg = jax_flash._Cfg(causal=causal, sm_scale=float(scale), block_q=64,
                         block_k=64, interpret=True)
    jq, jk, jv, jdo = (_to_bh(x).astype(dtype) for x in (q, k, v, do))
    o, lse = jax_flash._fwd(jq, jk, jv, cfg)
    grads = jax_flash._bwd(jq, jk, jv, o, lse, jdo, cfg)
    o_port = _from_bh(o.astype(jnp.float32), B, H)
    lse_port = np.array(lse, np.float32).reshape(B, H, T)
    return o_port, lse_port, [_from_bh(g.astype(jnp.float32), B, H)
                              for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_bwd_plain_matches_jax_pallas_kernels(T, causal):
    q, k, v, do = _arrays(T + causal, 4, 2, T, 2, 64)
    o, lse, want = _jax_bwd(q, k, v, do, causal, jnp.float32)
    got = t_flash._bwd_plain(*(torch.from_numpy(x)
                               for x in (q, k, v, o, lse, do)),
                             causal, 1.0 / np.sqrt(64))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == q.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_bf16_matches_jax_pallas_kernels(causal):
    """In bf16 both sides round ds and p to bf16 before the products,
    and the outputs to bf16."""
    q, k, v, do = _arrays(40 + causal, 4, 1, 128, 2, 64)
    o, lse, want = _jax_bwd(q, k, v, do, causal, jnp.bfloat16)
    ins = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = t_flash._bwd_plain(
        *ins, torch.from_numpy(o).to(torch.bfloat16), torch.from_numpy(lse),
        torch.from_numpy(do).to(torch.bfloat16), causal, 1.0 / np.sqrt(64))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), w, atol=BF16_TOL,
                                   rtol=BF16_TOL, err_msg=name)


def _torch_grads(fn, q, k, v):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fn(tq, tk, tv)
    (o * torch.cos(o)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_grads(fn, q, k, v):
    def loss(a, b, c):
        o = fn(a, b, c)
        return jnp.sum(o * jnp.cos(o))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal", [True, False])
def test_function_grads_match_jax_flash_vjp(causal):
    """The autograd Function's backward (the plain one on the CPU)
    against jax.grad through the custom VJP of the Pallas kernels."""
    q, k, v = _arrays(3 + causal, 3, 2, 128, 2, 64)
    got = _torch_grads(lambda a, b, c: t_flash.flash_attention(
        a, b, c, causal=causal), q, k, v)
    want = _jax_grads(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal=causal, block_q=64, block_k=64, interpret=True),
        q, k, v)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_ragged_length_grads_match_jax_reference():
    """T=100 is no multiple of the kernels' tile: causal_attention's
    gradients against jax.grad of the einsum reference."""
    q, k, v = _arrays(100, 3, 1, 100, 3, 64)
    got = _torch_grads(t_attention.causal_attention, q, k, v)
    want = _jax_grads(jax_ref, q, k, v)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_sm_scale_reaches_the_backward():
    q, k, v = _arrays(9, 3, 1, 64, 2, 64)
    got = _torch_grads(lambda a, b, c: t_flash.flash_attention(
        a, b, c, sm_scale=0.3), q, k, v)
    want = _jax_grads(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, sm_scale=0.3, block_q=64, block_k=64, interpret=True),
        q, k, v)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_grads_reach_only_inputs_that_require_them():
    q, k, v = (torch.from_numpy(x) for x in _arrays(12, 3, 1, 64, 2, 64))
    q.requires_grad_()
    t_flash.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert k.grad is None and v.grad is None


def test_strided_qkv_slices_get_their_grads():
    """q, k and v as column slices of one fused projection (as the
    model makes them): the grads land in the fused tensor."""
    B, T, H, D = 1, 64, 2, 64
    rng = np.random.RandomState(13)
    qkv = torch.from_numpy(rng.normal(size=(B, T, 3 * H * D)).astype(
        np.float32)).requires_grad_()
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    t_flash.flash_attention(q, k, v).square().sum().backward()
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = (t.reshape(B, T, H, D) for t in ref.split(H * D, dim=-1))
    t_attention.causal_attention_reference(rq, rk, rv).square().sum() \
        .backward()
    np.testing.assert_allclose(qkv.grad.numpy(), ref.grad.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_meta_tensor_never_falls_back():
    """Off the CPU the backward launches the kernels or raises: a tensor
    on another device (meta here) is refused, and no launch counts."""
    B, T, H, D = 1, 64, 2, 64
    x = torch.empty((B, T, H, D), device="meta")
    lse = torch.empty((B, H, T), device="meta")
    dq0, dkv0 = t_flash.LAUNCHES_DQ.count, t_flash.LAUNCHES_DKV.count
    with pytest.raises(ValueError, match="CUDA"):
        t_flash._bwd(x, x, x, x, lse, x, True, 0.125)
    assert t_flash.LAUNCHES_DQ.count == dq0
    assert t_flash.LAUNCHES_DKV.count == dkv0
