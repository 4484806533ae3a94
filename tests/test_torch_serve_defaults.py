"""The port's engine (ray_tpu_torch.serve.llm) against the JAX engine at
the JAX defaults and with speculative decoding, on GPT-2 tiny and Llama
tiny in float32 with the same converted parameters: identical greedy
streams with chunked prefill, prefix-cache hits (a shared-prefix second
wave whose hit count equals JAX's) and dense decode; identical greedy
streams with speculative K=4 on the dense and the paged verify paths,
also under preemption, with a pool that drains; and update_weights
invalidating the prefix cache. Every engine also builds and serves at
``EngineConfig(model=m, preset="tiny")`` with nothing else set."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.models import llama as jax_llama
from ray_tpu.serve.llm import config as jax_config
from ray_tpu.serve.llm import engine as jax_engine
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.serve.llm import config as t_config
from ray_tpu_torch.serve.llm import engine as t_engine

ATOL = 1e-4
MODELS = ("gpt2", "llama")


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, JAX cfg, port cfg, JAX params, port params), float32."""
    if request.param == "gpt2":
        jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(),
                                   dtype=jnp.float32, remat=False)
        tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(),
                                   dtype=torch.float32)
        jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    else:
        jcfg, tcfg = jax_llama.LlamaConfig.tiny(), t_llama.LlamaConfig.tiny()
        jp = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, jp, interop.params_from_jax(jp)


def _engines(model, **over):
    """The JAX engine and the port's on the CPU, same config and params
    (small pages, chunks of 8, a 64-token context)."""
    name, jcfg, tcfg, jp, tp = model
    kw = dict(model=name, block_size=4, num_blocks=64, max_model_len=64,
              max_batch_size=4, prefill_chunk_size=8, seed=0)
    kw.update(over)
    je = jax_engine.LLMEngine(jax_config.EngineConfig(
        model_config=jcfg, **kw), params=jp)
    te = t_engine.LLMEngine(t_config.EngineConfig(
        model_config=tcfg, **kw), params=tp, device="cpu")
    return je, te


def _drive(engine, prompts, max_tokens=12, logprobs=True):
    mod = jax_config if isinstance(engine, jax_engine.LLMEngine) \
        else t_config
    sp = mod.SamplingParams(max_tokens=max_tokens, logprobs=logprobs)
    streams = [engine.add_request(p, sp) for p in prompts]
    for _ in range(3000):
        if all(s.final() is not None for s in streams):
            break
        engine.step()
    events = [list(s) for s in streams]
    return [s.final() for s in streams], events


def _same_streams(want, got, events=None):
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["token_ids"] == w["token_ids"], i
        assert g["finish_reason"] == w["finish_reason"], i
        assert g["preemptions"] == w["preemptions"], i
        assert g["cached_tokens"] == w["cached_tokens"], i
        if "logprobs" in w:
            np.testing.assert_allclose(g["logprobs"], w["logprobs"],
                                       atol=ATOL)
    for g, ev in zip(got, events or []):
        assert [e["token"] for e in ev] == g["token_ids"]
        assert [e["index"] for e in ev] == list(range(len(g["token_ids"])))


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).tolist() for n in lens]


def _repetitive(vocab, seed, n=6):
    """Prompts a prompt-lookup proposer drafts for: a motif repeated."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        motif = rng.randint(1, vocab, 2 + i % 4).tolist()
        out.append((motif * 12)[:10 + 3 * i])
    return out


def test_defaults_chunked_prefix_dense_match_jax(model):
    """Chunked prefill (prompts of 3..29 tokens in chunks of 8), the
    prefix cache and dense decode; then a second wave that shares 16 and
    12 tokens of wave 1's prompts hits the cache as JAX's does."""
    je, te = _engines(model)
    assert not te.runner.use_paged_attention
    assert te.pool.enable_prefix_cache and te.runner.prefill_chunk_size == 8
    vocab = model[1].vocab_size
    wave1 = _prompts(vocab, (29, 3, 17, 8, 21), seed=41)
    want, _ = _drive(je, wave1)
    got, events = _drive(te, wave1)
    _same_streams(want, got, events)
    hits = te.stats()["prefix_hit_pages"]
    tails = _prompts(vocab, (5, 9, 2), seed=42)
    wave2 = [wave1[0][:16] + tails[0], wave1[2][:12] + tails[1],
             wave1[0][:16] + tails[2]]
    want, _ = _drive(je, wave2)
    got, events = _drive(te, wave2)
    _same_streams(want, got, events)
    st, jst = te.stats(), je.stats()
    assert st["prefix_hit_pages"] == jst["prefix_hit_pages"]
    assert st["prefix_hit_pages"] - hits >= 4 + 3 + 4
    assert [g["cached_tokens"] for g in got] == [16, 12, 16]
    assert st["blocks_used"] == 0 and st["running"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_streams_match_jax_and_spec_off(model, paged):
    """Greedy streams with speculative K=4 equal the JAX engine's, and
    the port's own spec-off streams, in f32; drafts were proposed and
    some accepted."""
    je, te = _engines(model, speculative={"num_draft_tokens": 4},
                      use_paged_attention=paged)
    assert te.runner.use_paged_attention == paged
    assert te.runner.spec_width == 5
    prompts = _repetitive(model[1].vocab_size, seed=43)
    want, _ = _drive(je, prompts, max_tokens=16)
    got, events = _drive(te, prompts, max_tokens=16)
    _same_streams(want, got, events)
    st, jst = te.stats(), je.stats()
    assert st["spec_proposed"] == jst["spec_proposed"] > 0
    assert st["spec_accepted"] == jst["spec_accepted"] > 0
    _, off = _engines(model, use_paged_attention=paged)
    plain, _ = _drive(off, prompts, max_tokens=16, logprobs=False)
    assert [g["token_ids"] for g in got] == [p["token_ids"] for p in plain]


def test_speculative_under_preemption_drains(model):
    """A pool too small for the batch preempts drafted lanes: the streams
    still equal JAX's, and every page comes back."""
    je, te = _engines(model, speculative={"num_draft_tokens": 4},
                      num_blocks=12, max_model_len=32,
                      prefill_chunk_size=0, use_paged_attention=True)
    prompts = _repetitive(model[1].vocab_size, seed=44, n=4)
    want, _ = _drive(je, prompts, max_tokens=12)
    got, events = _drive(te, prompts, max_tokens=12)
    assert sum(g["preemptions"] for g in got) > 0
    _same_streams(want, got, events)
    st = te.stats()
    assert st["preemptions"] == je.stats()["preemptions"]
    assert st["blocks_used"] == 0 and st["running"] == 0
    assert all(g["finish_reason"] == "length" for g in got)


def test_update_weights_invalidates_prefix_cache(model):
    """After a swap no admission matches old-weight pages: the same
    prompt misses the cache and its stream follows the new weights."""
    name, _, tcfg, _, tp = model
    te = t_engine.LLMEngine(t_config.EngineConfig(
        model=name, model_config=tcfg, block_size=4, num_blocks=64,
        max_model_len=64, prefill_chunk_size=8), params=tp, device="cpu")
    sp = t_config.SamplingParams(max_tokens=6)
    prompt = _prompts(tcfg.vocab_size, (19,), seed=45)[0]
    first = te.generate(prompt, sp, drive=True)
    again = te.generate(prompt, sp, drive=True)
    assert again["cached_tokens"] == 16 and te.pool.num_cached() > 0
    assert again["token_ids"] == first["token_ids"]
    scaled = interop.params_to_numpy(tp)
    scaled["wte"] = scaled["wte"] * 3.0
    out = te.update_weights(1, scaled)
    assert out["registrations_dropped"] > 0 and te.pool.num_cached() == 0
    after = te.generate(prompt, sp, drive=True)
    assert after["cached_tokens"] == 0 and after["weight_version"] == 1
    fresh = t_engine.LLMEngine(t_config.EngineConfig(
        model=name, model_config=tcfg, block_size=4, num_blocks=64,
        max_model_len=64, prefill_chunk_size=8),
        params=interop.params_from_jax(scaled), device="cpu")
    assert after["token_ids"] == fresh.generate(prompt, sp,
                                                drive=True)["token_ids"]


@pytest.mark.parametrize("name", MODELS)
def test_serves_at_every_default(name):
    """EngineConfig(model=m, preset="tiny") and nothing else: chunked
    prefill at 256, the prefix cache, dense decode, seeded random
    weights in the preset's dtype, on the CPU when asked for."""
    te = t_engine.LLMEngine(t_config.EngineConfig(model=name,
                                                  preset="tiny"),
                            device="cpu")
    assert te.runner.prefill_chunk_size == 128  # 256, capped by the model
    assert te.pool.enable_prefix_cache and not te.runner.use_paged_attention
    assert te.scheduler.spec_tokens == 0
    sp = t_config.SamplingParams(max_tokens=5)
    assert not te.has_work()
    outs = [te.generate(p, sp, drive=True)
            for p in _prompts(te.model_cfg.vocab_size, (3, 40), seed=46)]
    assert [o["num_generated"] for o in outs] == [5, 5]
    assert all(0 <= t < te.model_cfg.vocab_size
               for o in outs for t in o["token_ids"])
    assert te.warmup() == 2 * 4 + 4  # 16..128 twice; decode 1, 2, 4, 8
    assert te.stats()["blocks_used"] == 0
