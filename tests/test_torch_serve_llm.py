"""The port's serving stack (ray_tpu_torch.serve.llm) against the JAX
package's: the same scheduling and pool decisions over one scripted
request sequence, identical greedy token streams (with a forced
preemption) and prefill/decode logits at 1e-4 on GPT-2 tiny in float32
with the same converted parameters, the same top-k/top-p kept sets,
the engine's device rule, and chunked prefill, speculative decoding and
dense decode each serving like the JAX engine's."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.serve.llm import cache as jax_cache
from ray_tpu.serve.llm import config as jax_config
from ray_tpu.serve.llm import engine as jax_engine
from ray_tpu.serve.llm import runner as jax_runner
from ray_tpu.serve.llm import scheduler as jax_scheduler
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.serve.llm import cache as t_cache
from ray_tpu_torch.serve.llm import config as t_config
from ray_tpu_torch.serve.llm import engine as t_engine
from ray_tpu_torch.serve.llm import runner as t_runner
from ray_tpu_torch.serve.llm import scheduler as t_scheduler

ATOL = 1e-4
JAX = (jax_cache, jax_config, jax_scheduler)
PORT = (t_cache, t_config, t_scheduler)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(),
                               dtype=torch.float32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, interop.params_from_jax(jp)


def _engine_kwargs(**over):
    kw = dict(block_size=4, num_blocks=12, max_model_len=32,
              max_batch_size=4, prefill_chunk_size=0,
              use_paged_attention=True, seed=0)
    kw.update(over)
    return kw


# ------------------------------------------------------- scheduling


def _schedule_trace(mods):
    """Drive a scheduler over a pool too small for its requests, with
    deterministic tokens; record every decision and the pool state."""
    cache, config, scheduler = mods
    pool = cache.BlockPool(10, 4, enable_prefix_cache=False)
    sch = scheduler.Scheduler(pool, max_batch_size=3, max_model_len=32)
    for i, n in enumerate((5, 9, 6, 11)):
        sch.add(scheduler.Sequence(
            seq_id=i, prompt=list(range(1, n + 1)),
            sampling=config.SamplingParams(max_tokens=10,
                                           eos_token_id=97)))
    trace, tok = [], 90
    for _ in range(400):
        work = sch.schedule()
        retired = [s.seq_id for s in sch.take_retired()]
        if work is None:
            if not (sch.waiting or sch.running):
                break
            trace.append(("idle", retired))
            continue
        if isinstance(work, scheduler.PrefillWork):
            trace.append(("prefill", work.seq.seq_id, work.start, work.end,
                          work.is_last, tuple(work.seq.table)))
            seqs = [work.seq]
        else:
            seqs = list(work.seqs)
            trace.append(("decode", tuple(s.seq_id for s in seqs),
                          tuple(tuple(s.table) for s in seqs)))
        for s in seqs:
            tok = 90 + (tok + 3) % 9  # hits eos (97) now and then
            sch.commit_token(s, tok)
        trace.append(("pool", pool.num_free(), sch.preemption_count,
                      retired, sch.depth()))
    return trace, sch.preemption_count


def test_scheduler_and_pool_decide_like_jax():
    want, n_pre = _schedule_trace(JAX)
    got, _ = _schedule_trace(PORT)
    assert n_pre > 0, "the script must force a preemption"
    assert got == want


def test_block_pool_prefix_index_like_jax():
    """BlockPool's refcount / LRU / first-writer-wins bookkeeping is a
    copy: one scripted sequence of calls gives the same results."""
    def script(cache):
        pool = cache.BlockPool(num_blocks=6, block_size=4)
        h = cache.chain_hashes(list(range(1, 13)), 4, 3)
        out = [h]
        a = pool.alloc(2)
        pool.register(a[0], h[0])
        pool.register(a[1], h[1])
        out.append(pool.match_prefix(h[:2]))
        pool.free(a)
        out.append((pool.refcount(a[0]), pool.num_cached()))
        pool.free(out[-2])
        out.append((pool.num_cached(), pool.num_free(), pool.num_used()))
        m2 = pool.match_prefix(h)
        pool.free(m2)
        b = pool.alloc(4)
        out += [a, m2, b, pool.evictions, pool.match_prefix(h[:2]),
                pool.stats(), pool.invalidate_prefix_cache()]
        return out

    assert script(t_cache) == script(jax_cache)


# -------------------------------------------------------- runner logits


def test_runner_prefill_and_decode_logits_match_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    ja = jax_runner.adapters()["gpt2"]
    ta = t_runner.adapters()["gpt2"]
    kw = dict(block_size=4, num_blocks=24, max_model_len=32,
              max_batch_size=4)
    jr = jax_runner.ModelRunner(ja, jcfg, jp, use_paged_attention=True,
                                **kw)
    tr = t_runner.ModelRunner(ta, tcfg, tp, device="cpu", **kw)
    rng = np.random.RandomState(4)
    seqs = [rng.randint(1, jcfg.vocab_size, n + 6).tolist() for n in (5, 11)]
    pool = t_cache.BlockPool(24, 4)
    tables = []
    for s, n in zip(seqs, (5, 11)):
        table = pool.alloc(pool.blocks_for_tokens(len(s)))
        tables.append(table)
        jt, jl = jr.prefill(s[:n], table, 0.0)
        tt, tl = tr.prefill(s[:n], table, 0.0)
        assert jt == tt
        np.testing.assert_allclose(tl, jl, atol=ATOL)
    for i in range(6):  # teacher-forced, both lanes in one batch
        items = [(s[n + i], n + i, t) for s, n, t in
                 zip(seqs, (5, 11), tables)]
        jt, jl = jr.decode([jax_runner.DecodeItem(*it, 0.0)
                            for it in items])
        tt, tl = tr.decode([t_runner.DecodeItem(*it, 0.0)
                            for it in items])
        assert jt == tt
        np.testing.assert_allclose(tl, jl, atol=ATOL)


# ------------------------------------------------------------ sampling


def test_truncation_kept_sets_match_jax(monkeypatch):
    """The port's top-k / top-p cutoff keeps the same tokens as the JAX
    runner's in-jit `trunc_cut` (read from the logits it hands to
    jax.random.categorical)."""
    rng = np.random.RandomState(5)
    S, V, vocab = 7, 256, 250
    logits = (rng.normal(size=(S, V)) * 3).astype(np.float32)
    temps = np.asarray([0.7, 1.0, 1.3, 0.5, 1.0, 2.0, 1.0], np.float32)
    topks = np.asarray([0, 5, 0, 17, 3, 0, 0], np.int32)
    topps = np.asarray([0.9, 1.0, 0.5, 0.8, 1.0, 0.3, 1.0], np.float32)
    seen = {}

    def categorical(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(vocab_size=vocab),
                                 _base_key=jax.random.PRNGKey(0))
    jax_runner.ModelRunner._sample(fake, jnp.asarray(logits),
                                   jnp.asarray(temps), jnp.asarray(topks),
                                   jnp.asarray(topps), 1)
    want = np.isfinite(seen["logits"])

    lg = torch.from_numpy(logits)
    lg = torch.where(torch.arange(V) < vocab, lg, -1e30)
    cut = t_runner.truncation_cut(lg, torch.from_numpy(temps),
                                  torch.from_numpy(topks),
                                  torch.from_numpy(topps))
    got = (lg >= cut).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got[1].sum() <= 5 and got[4].sum() == 3


def test_sampling_greedy_exact_and_sampled_within_kept_set(tiny):
    _, tcfg, _, tp = tiny
    r = t_runner.ModelRunner(t_runner.adapters()["gpt2"], tcfg, tp,
                             device="cpu", block_size=4, num_blocks=8,
                             max_model_len=16, max_batch_size=4,
                             sample_seed=3)
    rng = np.random.RandomState(6)
    logits = torch.from_numpy(
        (rng.normal(size=(3, tcfg.padded_vocab)) * 3).astype(np.float32))
    logits[:, tcfg.vocab_size:] = 100.0  # padding must never win
    temps = np.asarray([0.0, 1.0, 0.8], np.float32)
    topks = np.asarray([0, 4, 0], np.int32)
    topps = np.asarray([1.0, 1.0, 0.6], np.float32)
    masked = torch.where(r._vocab_ok, logits, -1e30)
    cut = t_runner.truncation_cut(masked, torch.tensor([1.0, 1.0, 0.8]),
                                  torch.from_numpy(topks),
                                  torch.from_numpy(topps))
    kept = masked >= cut
    draws = [r._sample(logits, temps, topks, topps) for _ in range(40)]
    for d in draws:
        assert int(d[0]) == int(masked[0].argmax())
        assert bool(kept[1, d[1]]) and bool(kept[2, d[2]])
    assert len({int(d[1]) for d in draws}) > 1  # it does sample
    # a greedy batch never draws from the generator
    state = r._gen.get_state()
    r._sample(logits, np.zeros(3, np.float32), topks, topps)
    assert torch.equal(state, r._gen.get_state())


# -------------------------------------------------------------- engine


def _drive(engine, prompts, sampling):
    streams = [engine.add_request(p, sampling) for p in prompts]
    for _ in range(2000):
        if all(s.final() is not None for s in streams):
            break
        engine.step()
    events = [list(s) for s in streams]
    return [s.final() for s in streams], events


def test_engine_greedy_streams_match_jax_with_preemption(tiny):
    jcfg, tcfg, jp, tp = tiny
    je = jax_engine.LLMEngine(jax_config.EngineConfig(
        model_config=jcfg, **_engine_kwargs()), params=jp)
    te = t_engine.LLMEngine(t_config.EngineConfig(
        model_config=tcfg, **_engine_kwargs()), params=tp, device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, jcfg.vocab_size, n).tolist()
               for n in (5, 9, 7, 6)]
    want, _ = _drive(je, prompts, jax_config.SamplingParams(
        max_tokens=12, logprobs=True))
    got, events = _drive(te, prompts, t_config.SamplingParams(
        max_tokens=12, logprobs=True))
    assert sum(f["preemptions"] for f in want) > 0
    for w, g, ev in zip(want, got, events):
        assert g["token_ids"] == w["token_ids"]
        assert g["finish_reason"] == w["finish_reason"] == "length"
        assert g["preemptions"] == w["preemptions"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], atol=ATOL)
        assert [e["token"] for e in ev] == g["token_ids"]
        assert [e["index"] for e in ev] == list(range(12))
        assert abs(sum(v for k, v in g["breakdown"].items()
                       if k != "e2e") - g["breakdown"]["e2e"]) < 1e-3
    st = te.stats()
    assert st["preemptions"] == je.stats()["preemptions"]
    assert st["blocks_used"] == 0 and st["running"] == 0
    assert st["paged_attention"] and st["device"] == "cpu"


def test_engine_update_weights_and_abort(tiny):
    _, tcfg, _, tp = tiny
    te = t_engine.LLMEngine(t_config.EngineConfig(
        model_config=tcfg, **_engine_kwargs(num_blocks=32)), params=tp,
        device="cpu")
    sp = t_config.SamplingParams(max_tokens=6)
    before = te.generate([3, 4, 5], sp, drive=True)
    out = te.update_weights(1, interop.params_to_numpy(tp))
    assert out["previous_version"] == 0 and te.weight_version == 1
    after = te.generate([3, 4, 5], sp, drive=True)
    assert after["token_ids"] == before["token_ids"]
    assert after["weight_version"] == 1 and not after["stale"]
    with pytest.raises(ValueError, match="increase"):
        te.update_weights(1, tp)
    bad = dict(tp, wte=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="shape"):
        te.update_weights(2, bad)
    stream = te.add_request([1, 2, 3, 4, 5], t_config.SamplingParams(
        max_tokens=20))
    te.step()
    te.abort_request(stream)
    assert stream.final()["finish_reason"] == "aborted"
    assert te.stats()["blocks_used"] == 0
    assert te.warmup() == 2 + 3  # prefill 16, 32 (cap); decode 1, 2, 4
    assert te.runner.k_pages.abs().sum() > 0
    te.runner.reset_cache()
    assert not te.runner.k_pages.any() and not te.runner.v_pages.any()


def test_engine_defaults_to_cuda(tiny):
    """Without a device the engine runs on CUDA, and where CUDA is
    absent it raises instead of dropping to the CPU."""
    _, tcfg, _, tp = tiny
    cfg = t_config.EngineConfig(model_config=tcfg, **_engine_kwargs())
    if torch.cuda.is_available():
        assert t_engine.LLMEngine(cfg, params=tp).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_engine.LLMEngine(cfg, params=tp)


@pytest.mark.parametrize("over", [
    {"prefill_chunk_size": 256},
    {"speculative": {"num_draft_tokens": 4}},
    {"use_paged_attention": False},
])
def test_once_unported_features_serve_like_jax(tiny, over):
    """Chunked prefill, speculative decoding and the dense decode, each
    turned on alone over the paged monolithic engine, serve on the CPU
    with the JAX engine's greedy streams."""
    jcfg, tcfg, jp, tp = tiny
    kw = _engine_kwargs(num_blocks=32, **over)
    je = jax_engine.LLMEngine(jax_config.EngineConfig(
        model_config=jcfg, **kw), params=jp)
    te = t_engine.LLMEngine(t_config.EngineConfig(
        model_config=tcfg, **kw), params=tp, device="cpu")
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, jcfg.vocab_size, n).tolist()
               for n in (5, 9, 7)]
    prompts.append(prompts[0] * 3)  # a repeat the proposer drafts for
    want, _ = _drive(je, prompts, jax_config.SamplingParams(max_tokens=8))
    got, _ = _drive(te, prompts, t_config.SamplingParams(max_tokens=8))
    assert [g["token_ids"] for g in got] == [w["token_ids"] for w in want]
    st = te.stats()
    assert st["blocks_used"] == 0 and st["running"] == 0
    assert st["paged_attention"] == kw["use_paged_attention"]
    assert st["spec_proposed"] == je.stats()["spec_proposed"]


def test_engine_config_matches_jax_fields_and_checks():
    jf = {f.name: f.default for f in
          dataclasses.fields(jax_config.EngineConfig)}
    tf = {f.name: f.default for f in
          dataclasses.fields(t_config.EngineConfig)}
    assert tf == jf
    spec = t_config.EngineConfig(speculative={"num_draft_tokens": 3})
    want = jax_config.EngineConfig(speculative={"num_draft_tokens": 3})
    assert dataclasses.asdict(spec.speculative) \
        == dataclasses.asdict(want.speculative)
    assert type(spec.speculative).__name__ == "SpeculativeConfig"
    for bad in ({"num_draft_tokens": 0}, {"bogus": 1},
                {"method": "eagle"}, {"max_ngram": 1, "min_ngram": 2}):
        with pytest.raises(ValueError):
            t_config.EngineConfig(speculative=bad)
    with pytest.raises(TypeError):
        t_config.EngineConfig(speculative=3)
    with pytest.raises(ValueError):
        t_config.SamplingParams(top_p=0.0)


def test_auto_num_blocks_floor_off_the_card():
    n = t_cache.auto_num_blocks(
        n_layer=2, n_kv_head=4, head_dim=32, block_size=16, dtype_bytes=2,
        max_model_len=1024, max_batch_size=8, device="cpu")
    assert n == 2 * 8 * 64 + 1
