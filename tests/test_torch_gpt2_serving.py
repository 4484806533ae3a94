"""The port's GPT-2 serving steps (ray_tpu_torch.models.gpt2) against
the JAX model's on GPT2Config.tiny() in float32, with the JAX parameters
converted through ray_tpu_torch.interop: chunked prefill from offsets 0,
16 and 48 with a ragged last chunk, the dense decode step, and the paged
verify window at W=5 holding 0, 2 and 4 drafts (the JAX paged-attention
kernel in interpret mode, the port's K4 through its plain version), at
atol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2

ATOL = 1e-4
SEQ = 60  # tokens of the test sequence; its context table holds 64


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(),
                               dtype=torch.float32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    toks = np.random.RandomState(11).randint(1, jcfg.vocab_size, SEQ)
    _, k, v = jax_gpt2.gpt2_prefill_kv(jp, jnp.asarray(toks[None]), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp), toks, \
        np.asarray(k), np.asarray(v)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _context(k, v, start, C=64):
    """The gathered context (L, 1, C, H, D) of the first `start`
    positions of a prefill's k/v, zero beyond, and its mask (1, C)."""
    kc = np.zeros(k.shape[:2] + (C,) + k.shape[3:], np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :start] = k[:, :, :start]
    vc[:, :, :start] = v[:, :, :start]
    return kc, vc, np.arange(C)[None] < start


@pytest.mark.parametrize("start,n,T", [(0, 16, 16), (16, 32, 32),
                                       (48, 12, 16)])
def test_prefill_chunk_matches_jax(models, start, n, T):
    """A chunk of n real tokens padded to T at absolute offset `start`,
    against the cached context of the positions before it; the last
    case is ragged (12 real tokens in a bucket of 16)."""
    jcfg, tcfg, jp, tp, toks, k, v = models
    chunk = np.zeros((1, T), np.int32)
    chunk[0, :n] = toks[start:start + n]
    kc, vc, ctx_mask = _context(k, v, start)
    chunk_mask = np.arange(T)[None] < n
    want = jax_gpt2.gpt2_prefill_chunk_kv(
        jp, jnp.asarray(chunk), jnp.int32(start), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ctx_mask), jnp.asarray(chunk_mask),
        jcfg)
    got = t_gpt2.gpt2_prefill_chunk_kv(
        tp, torch.from_numpy(chunk).long(), start, torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(ctx_mask),
        torch.from_numpy(chunk_mask), tcfg)
    for g, w in zip(got, want):
        _close(g, w)
    # the real rows equal the monolithic prefill of the whole sequence
    np.testing.assert_allclose(got[1][:, 0, :n].numpy(),
                               k[:, 0, start:start + n], atol=ATOL)


def test_prefill_chunk_gathers_positions_past_the_table(models):
    """A bucket that runs past n_positions clips only its padded rows:
    the real rows keep their own position embeddings."""
    jcfg, tcfg, jp, tp, toks, _, _ = models
    start, n, T = 120, 8, 16  # block_size 128: rows 8..15 clip
    chunk = np.zeros((1, T), np.int32)
    chunk[0, :n] = toks[:n]
    C = 128
    kc = np.zeros((tcfg.n_layer, 1, C, tcfg.n_head, tcfg.head_dim),
                  np.float32)
    ctx_mask = np.zeros((1, C), bool)
    chunk_mask = np.arange(T)[None] < n
    want = jax_gpt2.gpt2_prefill_chunk_kv(
        jp, jnp.asarray(chunk), jnp.int32(start), jnp.asarray(kc),
        jnp.asarray(kc), jnp.asarray(ctx_mask), jnp.asarray(chunk_mask),
        jcfg)
    got = t_gpt2.gpt2_prefill_chunk_kv(
        tp, torch.from_numpy(chunk).long(), start, torch.from_numpy(kc),
        torch.from_numpy(kc), torch.from_numpy(ctx_mask),
        torch.from_numpy(chunk_mask), tcfg)
    for g, w in zip(got, want):
        _close(g, w)


def test_decode_dense_matches_jax(models):
    """One dense decode step for two sequences at positions 37 and 59,
    over a context gathered from the prefill."""
    jcfg, tcfg, jp, tp, toks, k, v = models
    C = 64
    positions = np.asarray([37, 59], np.int32)
    kc = np.zeros((k.shape[0], 2, C) + k.shape[3:], np.float32)
    vc = np.zeros_like(kc)
    for b, p in enumerate(positions):
        kc[:, b, :p] = k[:, 0, :p]
        vc[:, b, :p] = v[:, 0, :p]
    ctx_mask = np.arange(C)[None] < positions[:, None]
    tokens = toks[positions].astype(np.int32)
    want = jax_gpt2.gpt2_decode_kv(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ctx_mask), jcfg)
    got = t_gpt2.gpt2_decode_kv(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(ctx_mask), tcfg)
    for g, w in zip(got, want):
        _close(g, w)
    # and the new K of the lane at 59 is the prefill's K at 59
    np.testing.assert_allclose(got[1][:, 1].numpy(), k[:, 0, 59],
                               atol=ATOL)


def _pages(k, v, start, bs=4, nb=24, seed=12):
    """Pages (L, nb, bs, H, D) holding the first `start` positions of a
    prefill's k/v through a permuted table (maxB = 16)."""
    rng = np.random.RandomState(seed)
    L = k.shape[0]
    kp = np.zeros((L, nb, bs) + k.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    table = np.zeros((16,), np.int32)
    table[:] = rng.permutation(np.arange(1, nb))[:16]
    for t in range(start):
        kp[:, table[t // bs], t % bs] = k[:, 0, t]
        vp[:, table[t // bs], t % bs] = v[:, 0, t]
    return kp, vp, table


@pytest.mark.parametrize("n_draft", [0, 2, 4])
def test_verify_paged_matches_jax(models, n_draft):
    """A verify window of W=5 rows at start=41: the frontier token, then
    n_draft drafts, zero padding to the width."""
    jcfg, tcfg, jp, tp, toks, k, v = models
    start, W = 41, 5
    kp, vp, table = _pages(k, v, start)
    window = np.zeros((1, W), np.int32)
    window[0, :1 + n_draft] = toks[start:start + 1 + n_draft]
    want = jax_gpt2.gpt2_verify_paged_kv(
        jp, jnp.asarray(window), jnp.int32(start), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jcfg, interpret=True)
    got = t_gpt2.gpt2_verify_paged_kv(
        tp, torch.from_numpy(window).long(), start, torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(table), tcfg)
    assert got[0].shape == (1, W, tcfg.padded_vocab)
    for g, w in zip(got, want):
        _close(g, w)
    # the accepted rows are the prefill's rows at the same positions
    full, _, _ = t_gpt2.gpt2_prefill_kv(
        tp, torch.from_numpy(toks[None]).long(), tcfg)
    rows = slice(start, start + 1 + n_draft)
    np.testing.assert_allclose(got[0][0, :1 + n_draft].numpy(),
                               full[0, rows].numpy(), atol=ATOL)
