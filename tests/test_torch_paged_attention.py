"""The port's paged attention (ray_tpu_torch.ops.paged_attention)
against the JAX package's Pallas kernel in interpret mode and its dense
reference, on the same seeded numpy inputs (the shapes of
tests/test_spec_decode.py: GQA, W in {1, 5}, ctx_len edges 0 / 7 /
full) plus an H == H_kv case. On the CPU the port's wrapper runs its
plain version; chip_smoke.py holds the CUDA kernel against it on the
card."""

import contextlib
import inspect
import types

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
    """The wrapper refuses shapes past the split kernel's shared memory;
    the GPT-2-small decode and GQA verify shapes fit, and so does every
    shape the first design's formula (one block per KV head and
    sequence, nine f32 states of the rows) admitted: the split takes no
    narrower range."""
    _, pages = t_paged.split_plan(8, 12, 64, 16)
    assert t_paged.smem_bytes(1, 64, 16, 2, pages) <= t_paged.MAX_SMEM_BYTES
    assert t_paged.smem_bytes(3 * 5, 64, 16, 2, pages) \
        <= t_paged.MAX_SMEM_BYTES
    assert t_paged.smem_bytes(8 * 32, 128, 16, 2, pages) \
        > t_paged.MAX_SMEM_BYTES
    worst = 10 ** 6  # pages a split: only the first 1024 are cached
    for D in t_paged.KERNEL_HEAD_DIMS:
        rows = 1
        while 4 * (rows * D + 9 * (rows * D + 2 * rows)) \
                <= t_paged.MAX_SMEM_BYTES:
            for bs in t_paged.KERNEL_BLOCK_SIZES:
                for esz in (2, 4):
                    assert t_paged.smem_bytes(rows, D, bs, esz, worst) \
                        <= t_paged.MAX_SMEM_BYTES, (rows, D, bs, esz)
            rows += 1


@pytest.mark.parametrize("S,HK,max_blocks,bs", [
    (8, 12, 64, 16), (1, 12, 64, 16), (1, 1, 1, 8), (3, 2, 6, 4),
    (256, 12, 64, 16), (4, 4, 0, 16), (1, 12, 5000, 32),
    (2, 8, 10 ** 6, 8)])
def test_split_plan_covers_every_page_once(S, HK, max_blocks, bs):
    """Split i walks pages [i c, (i + 1) c): every page index of
    0..max_blocks-1 falls in exactly one split, no split is empty of
    table entries, and the grid stays within CUDA's limits."""
    n_split, pages = t_paged.split_plan(S, HK, max_blocks, bs)
    assert 1 <= n_split <= t_paged.MAX_SPLITS
    assert 1 <= pages <= max(max_blocks, 1)
    covered = np.zeros(max_blocks, np.int64)
    for i in range(n_split):
        lo, hi = i * pages, min((i + 1) * pages, max_blocks)
        assert lo < hi or max_blocks == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_split_plan_depends_on_shapes_only():
    """The plan is a function of (S, H_kv, max_blocks, block_size) alone:
    it takes no ctx_len, so the launch never reads one back, and a
    decode batch fills the H100's 132 SMs, one long request included."""
    params = list(inspect.signature(t_paged.split_plan).parameters)
    assert params == ["num_seqs", "num_kv_heads", "max_blocks",
                      "block_size"]
    assert t_paged.split_plan(8, 12, 64, 16) == t_paged.split_plan(
        8, 12, 64, 16)
    for S in (1, 8):
        n_split, pages = t_paged.split_plan(S, 12, 64, 16)
        assert S * 12 * n_split >= 132
        assert pages * 16 >= t_paged.MIN_SPLIT_TOKENS


def test_kernel_launch_takes_the_plan_not_ctx_len(monkeypatch):
    """The CUDA launch passes the plan and reads no operand's value on
    the host: the wrapper is driven with a stand-in library and operands
    on the meta device, which hold no values, so any read would
    raise."""
    ops = [torch.from_numpy(x).to("meta") for x in _case(2, 1, 4, 2)]
    calls = {}

    class FakeLib:
        @staticmethod
        def rt_paged_attention(*args):
            calls["args"] = args
            return 0

        rt_paged_error_string = None

    monkeypatch.setattr(t_paged, "_check_kernel_operands",
                        lambda *a: None)
    monkeypatch.setattr(t_paged._build, "load", lambda name: FakeLib)
    monkeypatch.setattr(t_paged._build, "bind", lambda fn, *a: fn)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(t_paged.LAUNCHES, "count", 0)
    t_paged.paged_attention(*ops)
    S, HK, bs, maxB = (ops[0].shape[0], ops[1].shape[2], ops[3].shape[1],
                       ops[5].shape[1])
    assert calls["args"][-2:] == t_paged.split_plan(S, HK, maxB, bs)
    assert t_paged.LAUNCHES.count == 1


def test_non_cpu_tensor_never_falls_back():
    ops = [torch.from_numpy(x).to("meta") for x in _case(1, 1, 4, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        t_paged.paged_attention(*ops)
    assert t_paged.LAUNCHES.count == 0
