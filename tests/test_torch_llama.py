"""The port's Llama (ray_tpu_torch.models.llama) against the JAX model on
LlamaConfig.tiny() (float32, H=4 query heads over H_kv=2 KV heads), with
the JAX parameters converted through ray_tpu_torch.interop: the presets,
the init tree, RoPE at absolute positions, prefill, chunked prefill,
dense decode, paged decode and the paged verify window (the JAX
paged-attention kernel in interpret mode, the port's K4 through its
plain version), at atol 1e-4; and RoPE's prefill, chunk and decode
forms bit for bit against each other per position."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch import interop
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.serve.llm import runner as t_runner

ATOL = 1e-4
SEQ = 60


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny()
    tcfg = t_llama.LlamaConfig.tiny()
    jp = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    toks = np.random.RandomState(21).randint(1, jcfg.vocab_size, SEQ)
    _, k, v = jax_llama.llama_prefill_kv(jp, jnp.asarray(toks[None]), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp), toks, \
        np.asarray(k), np.asarray(v)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_presets_match_jax(preset):
    a = getattr(jax_llama.LlamaConfig, preset)()
    b = getattr(t_llama.LlamaConfig, preset)()
    for f in ("vocab_size", "n_layer", "n_head", "n_kv_head", "n_embd",
              "intermediate", "block_size", "rope_theta", "rms_eps",
              "remat", "head_dim", "padded_vocab"):
        assert getattr(a, f) == getattr(b, f), f
    assert str(b.dtype).split(".")[-1] == jnp.dtype(a.dtype).name


def test_init_tree_matches_jax_layout(models):
    """Same keys and shapes as the JAX tree (so interop maps one to the
    other unchanged), f32 masters on the CPU when asked for."""
    _, tcfg, jp, tp, _, _, _ = models
    mine = t_llama.init_llama(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    jl, ml, cl = (list(_leaves(t)) for t in (jp, mine, tp))
    assert [p for p, _ in jl] == [p for p, _ in ml] == [p for p, _ in cl]
    for (path, a), (_, b), (_, c) in zip(jl, ml, cl):
        assert tuple(b.shape) == a.shape == tuple(c.shape), path
        assert b.dtype == c.dtype == torch.float32, path
    assert abs(float(mine["wte"].std()) - 0.02) < 2e-3
    served = t_llama.serving_params(mine, t_llama.LlamaConfig.small())
    assert served["blocks"]["wq"].dtype == torch.bfloat16
    assert served["blocks"]["ln_attn"].dtype == torch.float32


def test_rope_matches_jax_at_positions():
    rng = np.random.RandomState(22)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    theta = 10000.0
    _close(t_llama._rope(torch.from_numpy(x), theta),
           jax_llama._rope(jnp.asarray(x), theta))
    _close(t_llama._rope_chunk(torch.from_numpy(x), 37, theta),
           jax_llama._rope_chunk(jnp.asarray(x), jnp.int32(37), theta))
    pos = np.asarray([5, 1000], np.int32)
    _close(t_llama._rope_at(torch.from_numpy(x[:, 0]),
                            torch.from_numpy(pos), theta),
           jax_llama._rope_at(jnp.asarray(x[:, 0]), jnp.asarray(pos), theta))


def test_rope_forms_agree_bit_for_bit():
    """Prefill, chunk and decode rotate a position alike to the bit, so a
    cached K equals the K decode would compute at that position."""
    x = torch.from_numpy(np.random.RandomState(23).normal(
        size=(1, 24, 2, 32)).astype(np.float32))
    full = t_llama._rope(x, 10000.0)
    chunk = t_llama._rope_chunk(x[:, 16:], 16, 10000.0)
    assert torch.equal(chunk, full[:, 16:])
    for t in (0, 7, 23):
        at = t_llama._rope_at(x[:, t], torch.tensor([t]), 10000.0)
        assert torch.equal(at, full[:, t])


def test_prefill_and_forward_match_jax(models):
    jcfg, tcfg, jp, tp, toks, k, v = models
    got = t_llama.llama_prefill_kv(tp, torch.from_numpy(toks[None]).long(),
                                   tcfg)
    assert got[1].shape == (tcfg.n_layer, 1, SEQ, tcfg.n_kv_head,
                            tcfg.head_dim)
    want_logits = jax_llama.llama_forward(jp, jnp.asarray(toks[None]), jcfg)
    for g, w in zip(got, (want_logits, k, v)):
        _close(g, w)
    _close(t_llama.llama_forward(tp, torch.from_numpy(toks[None]).long(),
                                 tcfg), want_logits)


def test_gqa_repeats_kv_heads_in_jnp_repeat_order(models):
    """With H=4 over H_kv=2, query heads 0, 1 read KV head 0 and heads
    2, 3 KV head 1: swapping the two KV heads' projections changes the
    output (tiling with .repeat would pair heads 0, 2 instead)."""
    jcfg, tcfg, jp, tp, toks, _, _ = models
    assert (tcfg.n_head, tcfg.n_kv_head) == (4, 2)
    D = tcfg.head_dim
    swapped = {**jp, "blocks": dict(jp["blocks"])}
    for name in ("wk", "wv"):
        w = np.asarray(jp["blocks"][name])
        swapped["blocks"][name] = np.concatenate(
            [w[..., D:], w[..., :D]], axis=-1)
    tok = jnp.asarray(toks[None, :12])
    ttok = torch.from_numpy(toks[None, :12]).long()
    outs = []
    for params in (jp, swapped):
        outs.append(t_llama.llama_prefill_kv(
            interop.params_from_jax(params), ttok, tcfg)[0])
        _close(outs[-1], jax_llama.llama_prefill_kv(params, tok, jcfg)[0])
    assert (outs[0] - outs[1]).abs().max() > 1e-3


@pytest.mark.parametrize("start,n,T", [(0, 16, 16), (16, 32, 32),
                                       (48, 12, 16)])
def test_prefill_chunk_matches_jax(models, start, n, T):
    jcfg, tcfg, jp, tp, toks, k, v = models
    C = 64
    chunk = np.zeros((1, T), np.int32)
    chunk[0, :n] = toks[start:start + n]
    kc = np.zeros(k.shape[:2] + (C,) + k.shape[3:], np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :start] = k[:, :, :start]
    vc[:, :, :start] = v[:, :, :start]
    ctx_mask = np.arange(C)[None] < start
    chunk_mask = np.arange(T)[None] < n
    want = jax_llama.llama_prefill_chunk_kv(
        jp, jnp.asarray(chunk), jnp.int32(start), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ctx_mask), jnp.asarray(chunk_mask),
        jcfg)
    got = t_llama.llama_prefill_chunk_kv(
        tp, torch.from_numpy(chunk).long(), start, torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(ctx_mask),
        torch.from_numpy(chunk_mask), tcfg)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[1][:, 0, :n].numpy(),
                               k[:, 0, start:start + n], atol=ATOL)


def test_decode_dense_matches_jax(models):
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
    want = jax_llama.llama_decode_kv(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ctx_mask), jcfg)
    got = t_llama.llama_decode_kv(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(ctx_mask), tcfg)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[1][:, 1].numpy(), k[:, 0, 59],
                               atol=ATOL)


def _pages(k, v, lens, bs=4, nb=40, seed=24):
    """Pages (L, nb, bs, H_kv, D) holding, for each length in `lens`,
    the first positions of the prefill's k/v through its own permuted
    table (S, 16)."""
    rng = np.random.RandomState(seed)
    L = k.shape[0]
    kp = np.zeros((L, nb, bs) + k.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    free = list(rng.permutation(np.arange(1, nb)))
    tables = np.zeros((len(lens), 16), np.int32)
    for s, n in enumerate(lens):
        tables[s] = [free.pop() for _ in range(16)]
        for t in range(n):
            kp[:, tables[s, t // bs], t % bs] = k[:, 0, t]
            vp[:, tables[s, t // bs], t % bs] = v[:, 0, t]
    return kp, vp, tables


def test_decode_paged_matches_jax(models):
    jcfg, tcfg, jp, tp, toks, k, v = models
    positions = np.asarray([37, 59], np.int32)
    kp, vp, tables = _pages(k, v, positions)
    tokens = toks[positions].astype(np.int32)
    want = jax_llama.llama_decode_paged_kv(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables), jcfg, interpret=True)
    got = t_llama.llama_decode_paged_kv(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), tcfg)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n_draft", [0, 2, 4])
def test_verify_paged_matches_jax(models, n_draft):
    jcfg, tcfg, jp, tp, toks, k, v = models
    start, W = 41, 5
    kp, vp, tables = _pages(k, v, [start])
    window = np.zeros((1, W), np.int32)
    window[0, :1 + n_draft] = toks[start:start + 1 + n_draft]
    want = jax_llama.llama_verify_paged_kv(
        jp, jnp.asarray(window), jnp.int32(start), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables[0]), jcfg, interpret=True)
    got = t_llama.llama_verify_paged_kv(
        tp, torch.from_numpy(window).long(), start, torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(tables[0]), tcfg)
    for g, w in zip(got, want):
        _close(g, w)
    full = t_llama.llama_forward(tp, torch.from_numpy(toks[None]).long(),
                                 tcfg)
    np.testing.assert_allclose(got[0][0, :1 + n_draft].numpy(),
                               full[0, start:start + 1 + n_draft].numpy(),
                               atol=ATOL)


def test_adapter_registers_llama():
    a = t_runner.adapters()["llama"]
    cfg = a.presets["small"]()
    assert a.kv_heads(cfg) == 4 and cfg.n_head == 12
    assert a.verify_paged_fn is t_llama.llama_verify_paged_kv
    assert a.decode_fn is t_llama.llama_decode_kv
