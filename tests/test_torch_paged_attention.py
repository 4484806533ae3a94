"""The port's paged attention (ray_tpu_torch.ops.paged_attention)
against the JAX package's Pallas kernel in interpret mode and its dense
reference, on the same seeded numpy inputs (the shapes of
tests/test_spec_decode.py: GQA, W in {1, 5}, ctx_len edges 0 / 7 /
full) plus an H == H_kv case. On the CPU the port's wrapper runs its
plain version; chip_smoke.py holds the CUDA kernel against it on the
card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_attention import (
    paged_attention as jax_paged,
    paged_attention_reference as jax_paged_ref,
)
from ray_tpu_torch.ops import paged_attention as t_paged

ATOL = 1e-4  # the JAX package's paged-attention tolerance


def _case(seed, W, H, HK, S=3, D=16, bs=4, maxB=6, npages=32):
    rng = np.random.RandomState(seed)
    k_pages = rng.normal(size=(npages, bs, HK, D)).astype(np.float32)
    v_pages = rng.normal(size=(npages, bs, HK, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, npages))
    tables = perm[:S * maxB].reshape(S, maxB).astype(np.int32)
    ctx_len = np.asarray([0, 7, maxB * bs], np.int32)[:S]
    q = rng.normal(size=(S, W, H, D)).astype(np.float32)
    ok = rng.normal(size=(S, W, HK, D)).astype(np.float32)
    ov = rng.normal(size=(S, W, HK, D)).astype(np.float32)
    return q, ok, ov, k_pages, v_pages, tables, ctx_len


@pytest.mark.parametrize("H,HK", [(4, 2), (4, 4)])
@pytest.mark.parametrize("W", [1, 5])
def test_matches_jax_kernel_and_reference(W, H, HK):
    ops = _case(10 * W + HK, W, H, HK)
    got = t_paged.paged_attention(*(torch.from_numpy(x) for x in ops))
    assert got.shape == ops[0].shape and got.dtype == torch.float32
    want_kernel = jax_paged(*(jnp.asarray(x) for x in ops), interpret=True)
    want_ref = jax_paged_ref(*(jnp.asarray(x) for x in ops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL)


def test_null_lane_attends_only_its_window():
    """ctx_len = 0 (a padded decode lane) reads no page: the output is
    attention over the own window alone, whatever the table holds."""
    q, ok, ov, kp, vp, tables, _ = _case(3, 1, 4, 2)
    ctx0 = np.zeros((3,), np.int32)
    got = t_paged.paged_attention(
        *(torch.from_numpy(x) for x in (q, ok, ov, kp, vp, tables, ctx0)))
    # W = 1: the single own key gets all the weight
    want = np.repeat(ov, 2, axis=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_kernel_smem_formula_covers_serving_shapes():
    """The wrapper refuses shapes past the kernel's shared memory; the
    GPT-2-small decode and GQA verify shapes fit."""
    assert t_paged.smem_bytes(1, 64) <= t_paged.MAX_SMEM_BYTES
    assert t_paged.smem_bytes(3 * 5, 64) <= t_paged.MAX_SMEM_BYTES
    assert t_paged.smem_bytes(8 * 32, 128) > t_paged.MAX_SMEM_BYTES


def test_non_cpu_tensor_never_falls_back():
    ops = [torch.from_numpy(x).to("meta") for x in _case(1, 1, 4, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        t_paged.paged_attention(*ops)
    assert t_paged.LAUNCHES.count == 0
