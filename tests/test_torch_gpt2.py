"""The port's GPT-2 (ray_tpu_torch.models.gpt2) against the JAX model on
GPT2Config.tiny() in float32, with the JAX parameters converted through
ray_tpu_torch.interop (torch seeds cannot reproduce jax.random): the
interop round trip, the full forward, prefill (logits, k, v) and one
paged decode step, at atol 1e-4."""

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


def _cfgs():
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(),
                               dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_interop_round_trip(models):
    _, _, jp, tp = models
    back = interop.params_to_numpy(tp)
    jl, bl = list(_leaves(jp)), list(_leaves(back))
    assert [p for p, _ in jl] == [p for p, _ in bl]
    for (path, a), (_, b) in zip(jl, bl):
        assert b.dtype == np.float32 and b.shape == a.shape, path
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=path)


def test_interop_bf16_leaves_go_through_f32(models):
    _, _, jp, _ = models
    wte16 = jp["wte"].astype(jnp.bfloat16)
    t = interop.params_from_jax({"w": wte16})["w"]
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(wte16.astype(jnp.float32)))
    assert torch.equal(t.to(torch.bfloat16).float(), t)  # exact in bf16


def test_serving_params_bit_equal_to_jax_casts(models):
    """The runner's bf16 copies equal JAX's per-call .astype(bfloat16)
    bit for bit; layer norms stay float32."""
    _, tcfg, jp, tp = models
    served = t_gpt2.serving_params(tp, dataclasses.replace(
        tcfg, dtype=torch.bfloat16))
    for path, t in _leaves(served):
        jleaf = jp
        for k in path.strip("/").split("/"):
            jleaf = jleaf[k]
        if "/ln" in path:
            assert t.dtype == torch.float32, path
            continue
        assert t.dtype == torch.bfloat16, path
        want = np.asarray(jleaf.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), want,
                                      err_msg=path)


def test_init_tree_matches_jax_layout(models):
    jcfg, tcfg, jp, _ = models
    gen = torch.Generator().manual_seed(0)
    tp = t_gpt2.init_gpt2(gen, tcfg, device="cpu")
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
    assert abs(float(tp["wte"].std()) - 0.02) < 2e-3


def test_init_on_the_cpu_keeps_the_generator_draws():
    """device="cpu" gives CPU tensors equal to the generator's draws, in
    init order, from the same seed (the params before `device` existed)."""
    cfg = t_gpt2.GPT2Config.tiny()
    tp = t_gpt2.init_gpt2(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    gen = torch.Generator().manual_seed(0)
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.padded_vocab
    resid = 0.02 / (2 * L) ** 0.5
    want = [("blocks", "attn_qkv", (L, E, 3 * E), 0.02),
            ("blocks", "attn_proj", (L, E, E), resid),
            ("blocks", "mlp_fc", (L, E, 4 * E), 0.02),
            ("blocks", "mlp_proj", (L, 4 * E, E), resid),
            ("wte", None, (V, E), 0.02),
            ("wpe", None, (cfg.block_size, E), 0.02)]
    for top, name, shape, scale in want:
        leaf = tp[top][name]["kernel"] if name else tp[top]
        assert leaf.device.type == "cpu"
        assert torch.equal(leaf, torch.randn(shape, generator=gen) * scale)
    assert all(t.device.type == "cpu" for _, t in _leaves(tp))


def test_init_goes_to_the_card_by_default():
    """device=None asks for "cuda": without a card it raises and never
    quietly returns CPU tensors."""
    cfg = t_gpt2.GPT2Config.tiny()
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_gpt2.init_gpt2(gen, cfg)
        return
    tp = t_gpt2.init_gpt2(gen, cfg)
    assert all(t.is_cuda for _, t in _leaves(tp))


@pytest.mark.parametrize("preset", ["small", "medium", "large", "xl",
                                    "tiny"])
def test_presets_match_jax(preset):
    a = getattr(jax_gpt2.GPT2Config, preset)()
    b = getattr(t_gpt2.GPT2Config, preset)()
    for f in ("vocab_size", "n_layer", "n_head", "n_embd", "block_size",
              "vocab_pad_multiple", "padded_vocab", "head_dim"):
        assert getattr(a, f) == getattr(b, f), f
    assert b.dtype == torch.bfloat16


def test_forward_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.RandomState(1).randint(1, jcfg.vocab_size, (2, 19))
    want = jax_gpt2.gpt2_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got = t_gpt2.gpt2_forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_kv_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.RandomState(2).randint(1, jcfg.vocab_size, (2, 13))
    jl, jk, jv = jax_gpt2.gpt2_prefill_kv(jp, jnp.asarray(toks, jnp.int32),
                                          jcfg)
    tl, tk, tv = t_gpt2.gpt2_prefill_kv(tp, torch.from_numpy(toks), tcfg)
    L, H, D = tcfg.n_layer, tcfg.n_head, tcfg.head_dim
    assert tk.shape == (L, 2, 13, H, D) and tv.shape == tk.shape
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)


def test_decode_paged_step_matches_jax(models):
    """One paged decode step for two sequences of different lengths,
    pages filled from a JAX prefill through permuted block tables."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.RandomState(3)
    L, H, D = tcfg.n_layer, tcfg.n_head, tcfg.head_dim
    bs, nb, maxB = 4, 16, 4
    lens = [5, 9]
    k_pages = np.zeros((L, nb, bs, H, D), np.float32)
    v_pages = np.zeros_like(k_pages)
    tables = np.zeros((2, maxB), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    seqs = []
    for s, n in enumerate(lens):
        toks = rng.randint(1, jcfg.vocab_size, n + 1)
        seqs.append(toks)
        pages = [free.pop() for _ in range((n + 1 + bs - 1) // bs)]
        tables[s, :len(pages)] = pages
        _, k, v = jax_gpt2.gpt2_prefill_kv(
            jp, jnp.asarray(toks[None, :n], jnp.int32), jcfg)
        for t in range(n):
            k_pages[:, pages[t // bs], t % bs] = np.asarray(k)[:, 0, t]
            v_pages[:, pages[t // bs], t % bs] = np.asarray(v)[:, 0, t]
    tokens = np.asarray([seqs[0][5], seqs[1][9]], np.int32)
    positions = np.asarray(lens, np.int32)
    jl, jk, jv = jax_gpt2.gpt2_decode_paged_kv(
        jp, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(tables),
        jcfg, interpret=True)
    tl, tk, tv = t_gpt2.gpt2_decode_paged_kv(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        torch.from_numpy(k_pages), torch.from_numpy(v_pages),
        torch.from_numpy(tables), tcfg)
    assert tl.shape == (2, tcfg.padded_vocab) and tk.shape == (L, 2, H, D)
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)
    # and the step agrees with the full forward at that position
    for s, n in enumerate(lens):
        full = jax_gpt2.gpt2_forward(
            jp, jnp.asarray(seqs[s][None, :n + 1], jnp.int32), jcfg)
        np.testing.assert_allclose(tl[s].numpy(), np.asarray(full)[0, n],
                                   atol=ATOL)
