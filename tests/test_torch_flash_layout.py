"""The Python side of the TMA launch of the port's bf16 flash kernels
(ray_tpu_torch.ops.flash_attention): which operand layouts TMA can read
as they are, the strides the wrapper passes to the C launch (which
encodes each operand's tensor map from them), the one copy an unsuitable
layout gets, and
that the model's q, k, v (column slices of the fused qkv projection)
are never copied. The kernels themselves run only on the card
(chip_smoke.py); on the CPU the wrapper runs the plain version, which
is held against the JAX Pallas kernel on the same strided views here."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.ops import flash_attention as t_flash

H, D, E = 12, 64, 768  # GPT-2-small's heads
BF = torch.bfloat16


def _qkv_views(B, T, heads=H, d=D, dtype=BF):
    """q, k, v as the model hands them over: column slices of one
    (B, T, 3 E) projection, reshaped to (B, T, H, D)."""
    e = heads * d
    qkv = torch.zeros((B, T, 3 * e), dtype=dtype)
    return qkv, [t.reshape(B, T, heads, d) for t in qkv.split(e, dim=-1)]


@pytest.mark.parametrize("T", [1024, 731, 64, 17, 12, 1])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_contiguous_geometry(B, T, d):
    t = torch.zeros((B, T, H, d), dtype=BF)
    # (batch, time, head) in elements: a head d, a row H d, a sequence T
    # rows, also along the axes of size 1
    assert t_flash._strides(t) == (T * H * d, H * d, d)
    assert t_flash._tma_ok(t)
    assert t_flash._kernel_operand(t) is t


@pytest.mark.parametrize("T", [1024, 731, 64, 17, 12])
@pytest.mark.parametrize("B", [1, 8])
def test_qkv_split_views_geometry(B, T):
    qkv, views = _qkv_views(B, T)
    for i, t in enumerate(views):
        assert t.data_ptr() - qkv.data_ptr() == 2 * E * i  # 1536-byte steps
        # head 128 bytes, row 2304 elements, sequence T rows
        assert t_flash._strides(t) == (T * 3 * E, 3 * E, D)
        assert t_flash._tma_ok(t)
        assert t_flash._kernel_operand(t) is t


def test_size_one_axes_get_contiguous_strides():
    """A stride along an axis of size 1 is never followed, but TMA
    checks it: the wrapper passes the contiguous one instead."""
    base = torch.zeros(4096, dtype=BF)
    t = base.as_strided((1, 1, 1, 64), (3, 5, 7, 1))
    assert t_flash._strides(t) == (64, 64, 64)
    assert t_flash._tma_ok(t)
    assert not t_flash._tma_ok(base.as_strided((2, 1, 1, 64),
                                               (3, 5, 7, 1)))
    u = base.as_strided((2, 3, 1, 64), (3 * 72, 72, 9, 1))
    assert t_flash._strides(u) == (3 * 72, 72, 64)


def test_misaligned_base_is_copied_once():
    """An offset of 2 elements (4 bytes) breaks TMA's 16-byte rule for
    the base: the operand is copied once, not refused."""
    B, T = 1, 17
    base = torch.arange(B * T * H * D + 2, dtype=torch.float32).to(BF)
    t = base[2:].view(B, T, H, D)
    assert t.data_ptr() % 16 == 4
    assert not t_flash._tma_ok(t)
    before = t_flash.LAYOUT_COPIES.count
    out = t_flash._kernel_operand(t)
    assert t_flash.LAYOUT_COPIES.count == before + 1
    assert out.is_contiguous() and t_flash._tma_ok(out)
    assert torch.equal(out, t)


@pytest.mark.parametrize("strides", [
    (17 * 12 * 68, 12 * 68, 68, 1),   # rows padded by 4 elements
    (17 * 12 * 64, 64, 17 * 64, 1),   # (B, H, T, D) memory: fine
    (0, 12 * 64, 64, 1),              # a broadcast batch
])
def test_stride_rules(strides):
    base = torch.zeros(4 * 17 * 12 * 68, dtype=BF)
    t = base.as_strided((2, 17, 12, 64), strides)
    ok = all(s % 8 == 0 and s > 0 for s in strides[:3])
    assert t_flash._tma_ok(t) == ok
    before = t_flash.LAYOUT_COPIES.count
    out = t_flash._kernel_operand(t)
    assert (out is t) == ok
    assert t_flash.LAYOUT_COPIES.count == before + (not ok)
    assert torch.equal(out, t)


def test_f32_operands_are_never_copied():
    t = torch.zeros(4 * 17 * 12 * 68).as_strided((1, 17, 12, 64),
                                                (0, 12 * 68, 68, 1))
    assert t_flash._kernel_operand(t) is t


def test_model_views_are_never_copied(monkeypatch):
    """The q, k, v the bf16 model hands to attention (a block's qkv
    split) go to the kernels as they are."""
    cfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), n_head=2,
                              n_layer=2, remat=False)
    assert cfg.head_dim == 64 and cfg.dtype == BF
    seen = []
    real = t_gpt2.causal_attention

    def spy(q, k, v, *args, **kwargs):
        seen.append((q, k, v))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(t_gpt2, "causal_attention", spy)
    params = t_gpt2.init_gpt2(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    t_gpt2.gpt2_forward(params, tokens, cfg)
    assert len(seen) == cfg.n_layer
    before = t_flash.LAYOUT_COPIES.count
    for qkv in seen:
        for t in qkv:
            assert t.dtype == BF and not t.is_contiguous()
            assert t_flash._tma_ok(t)
            assert t_flash._kernel_operand(t) is t
    assert t_flash.LAYOUT_COPIES.count == before


@pytest.mark.parametrize("T", [128, 17])
def test_split_views_match_jax_pallas_kernel(T):
    """The wrapper on the qkv column slices (its plain version on the
    CPU) against the JAX Pallas kernel (interpret mode) on the same
    values, contiguous, at the JAX package's tolerance."""
    B, heads, d = 1, 2, 64
    rng = np.random.RandomState(T)
    x = rng.normal(size=(B, T, 3 * heads * d)).astype(np.float32)
    qkv = torch.from_numpy(x)
    q, k, v = (t.reshape(B, T, heads, d)
               for t in qkv.split(heads * d, dim=-1))
    got = t_flash.flash_attention(q, k, v)
    pad = -T % 64  # the JAX kernel needs whole 64-row blocks
    jq, jk, jv = (jnp.pad(jnp.asarray(t.contiguous().numpy()),
                          ((0, 0), (0, pad), (0, 0), (0, 0)))
                  for t in (q, k, v))
    want = jax_flash.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                     interpret=True)[:, :T]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
