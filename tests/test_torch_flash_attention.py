"""The port's flash-attention forward (ray_tpu_torch.ops.flash_attention)
against the JAX package: the Pallas kernel in interpret mode and the
einsum reference, on the same seeded numpy inputs. On the CPU the
port's wrapper runs its plain version; the CUDA kernel itself is held
against that plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu.ops.attention import causal_attention_reference as jax_ref
from ray_tpu_torch.ops import attention as t_attention
from ray_tpu_torch.ops import flash_attention as t_flash

ATOL = RTOL = 2e-5  # the JAX package's own flash forward tolerance


def _qkv(seed, B, T, H, D):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _np_lse(q, k, causal):
    """(B, H, T) logsumexp of the scaled (masked) logits, float64."""
    D = q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(D)
    if causal:
        T = q.shape[1]
        s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_forward_matches_jax_pallas_kernel(T, causal):
    q, k, v = _qkv(T + causal, 2, T, 2, 64)
    want = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=64, interpret=True)
    got = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T", [128, 256])
def test_causal_attention_matches_jax_reference(T):
    q, k, v = _qkv(7 * T, 2, T, 2, 64)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(
        t_attention.causal_attention(tq, tk, tv).numpy(), want,
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        t_attention.causal_attention_reference(tq, tk, tv).numpy(), want,
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_numpy_and_jax_fwd(causal):
    B, T, H, D = 2, 128, 2, 64
    q, k, v = _qkv(11 + causal, B, T, H, D)
    o, lse = t_flash._fwd(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal, 1.0 / np.sqrt(D))
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, causal),
                               atol=ATOL, rtol=RTOL)

    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, D)

    cfg = jax_flash._Cfg(causal=causal, sm_scale=1.0 / np.sqrt(D),
                         block_q=64, block_k=64, interpret=True)
    _, jax_lse = jax_flash._fwd(to_bh(q), to_bh(k), to_bh(v), cfg)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax_lse).reshape(B, H, T),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T", [1, 100])
def test_any_length_matches_reference(T):
    """The kernel masks its ragged edge, so the port takes any T (the
    TPU kernel needs T divisible by its block)."""
    q, k, v = _qkv(T, 1, T, 3, 64)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v)))
    got = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_sm_scale_is_applied():
    q, k, v = _qkv(5, 1, 64, 2, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = t_flash.flash_attention(tq, tk, tv, sm_scale=0.3)
    want = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=0.3,
        block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_non_cpu_tensor_never_falls_back():
    """Off the CPU the wrapper launches the kernel or raises: a tensor
    on another device (meta here) is refused, not sent to the plain
    version."""
    q = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.flash_attention(q, q, q)
    assert t_flash.LAUNCHES.count == 0
