"""The port's engine on a mesh (``LLMEngine(mesh=)``) against the JAX
engine on a mesh of the same shape, in float32 with the same converted
parameters: GPT-2 tiny (H=4) and Llama tiny (H=4, H_kv=2) on tensor=2
(two gloo ranks of the CPU) and tensor=4 (four ranks), each at
``EngineConfig()``'s defaults (chunked prefill, a shared-prefix second
wave that hits the prefix cache, dense decode), with paged attention,
and with speculative decoding (4 drafts, paged).

The reference is the JAX engine built with ``mesh=`` on as many of the
CPU devices that tests/conftest.py forces, params laid out by the
model's rules and pages sharded over ``tensor`` (Pallas in interpret
mode under GSPMD): identical greedy streams, logprobs (the logits'
log-softmax at the chosen tokens) within 1e-4, equal prefix-cache hits
and draft counts, and a pool that drains. Every rank's streams are
equal. The kernels' plain versions record the heads each rank attends:
its share of the heads where the KV heads divide over ``tensor``, and
all of them for Llama tiny at tensor=4, whose two KV heads are
replicated (every query head then reads the KV head it maps to). After
``update_weights`` on the mesh the streams equal those of a fresh mesh
engine and of a JAX engine built on the new weights. The pool's size at
a given memory size follows JAX's rule with ``tensor_ways``, and one
decode step issues the collectives the layouts call for.

The ranks run in one spawn for each mesh (test_torch_collectives.py's
`run_ranks`); jax is imported only inside functions of this module."""

import dataclasses
import types

import numpy as np
import pytest

from tests.test_torch_collectives import run_ranks

ATOL = 1e-4
MODELS = ("gpt2", "llama")
MODES = ("defaults", "paged", "spec")
WAYS = (2, 4)


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).tolist() for n in lens]


def _waves(vocab, mode):
    """The prompt waves of a mode and their max_tokens: two waves for
    the defaults and paged (wave 2 shares 32 and 16 tokens of wave 1's
    prompts, two and one 16-token pages), repeated motifs for spec."""
    if mode == "spec":
        rng = np.random.RandomState(43)
        motifs = [rng.randint(1, vocab, 2 + i % 3).tolist() for i in range(4)]
        return [[(m * 20)[:12 + 5 * i] for i, m in enumerate(motifs)]], 12
    wave1 = _prompts(vocab, (40, 3, 17, 8), seed=41)
    tails = _prompts(vocab, (5, 9), seed=42)
    return [wave1, [wave1[0][:32] + tails[0], wave1[2][:16] + tails[1]]], 8


def _engine_kw(mode):
    kw = {"seed": 0}
    if mode in ("paged", "spec"):
        kw["use_paged_attention"] = True
    if mode == "spec":
        kw["speculative"] = {"num_draft_tokens": 4}
    return kw


def _drive(engine, mod, prompts, max_tokens):
    sp = mod.SamplingParams(max_tokens=max_tokens, logprobs=True)
    streams = [engine.add_request(p, sp) for p in prompts]
    for _ in range(3000):
        if all(s.final() is not None for s in streams):
            break
        engine.step()
    return [{k: s.final()[k] for k in ("token_ids", "finish_reason",
                                        "logprobs", "cached_tokens",
                                        "preemptions")} for s in streams]


def _stats(engine):
    st = engine.stats()
    return {k: st[k] for k in ("prefix_hit_pages", "spec_proposed",
                               "spec_accepted", "blocks_used", "running")}


def _run_case(engine, mod, vocab, mode):
    waves, max_tokens = _waves(vocab, mode)
    return {"waves": [_drive(engine, mod, w, max_tokens) for w in waves],
            "stats": _stats(engine), "pool": engine.pool.num_blocks}


SWAP_PROMPT = (19,)


def _serve_body(rank, params):
    """Every (model, mode) on this rank's mesh, the heads each plain
    version saw, and the update_weights case."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.ops import attention, flash_attention, paged_attention
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.ops import collective_op_counts
    from ray_tpu_torch.serve.llm import config, engine
    from ray_tpu_torch.serve.llm.runner import DecodeItem
    from torch.distributed.tensor.debug import CommDebugMode

    ways = dist.get_world_size()
    mesh = build_mesh(MeshSpec(tensor=ways, data=1), device="cpu")
    seen: dict = {}

    def record(mod, name, head_dim):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            seen.setdefault(name, set()).add(args[0].shape[head_dim])
            return fn(*args, **kw)

        setattr(mod, name, wrapped)

    record(flash_attention, "_fwd_plain", 2)
    record(paged_attention, "paged_attention_reference", 2)
    record(attention, "_context_attention", 2)
    record(attention, "_context_decode_attention", 1)

    cfgs = {"gpt2": dataclasses.replace(gpt2.GPT2Config.tiny(),
                                        dtype=torch.float32),
            "llama": llama.LlamaConfig.tiny()}
    out = {}
    for model in MODELS:
        host = interop.params_from_jax(params[model])
        for mode in MODES:
            seen.clear()
            e = engine.LLMEngine(config.EngineConfig(
                model=model, model_config=cfgs[model], **_engine_kw(mode)),
                params=host, mesh=mesh, device="cpu")
            res = _run_case(e, config, cfgs[model].vocab_size, mode)
            res["heads"] = {k: sorted(v) for k, v in seen.items()}
            with CommDebugMode() as comm:
                e.runner.decode([DecodeItem(
                    1, 0, [0] * e.runner.max_blocks_per_seq, 0.0)])
            res["decode_collectives"] = collective_op_counts(comm)
            out[(model, mode)] = res
    # update_weights on the mesh, then a fresh mesh engine on the new
    # weights
    model = "gpt2"
    cfg = cfgs[model]
    host = interop.params_from_jax(params[model])
    new = interop.params_from_jax(params["gpt2_new"])
    sp = config.SamplingParams(max_tokens=6, logprobs=True)
    prompt = _prompts(cfg.vocab_size, SWAP_PROMPT, seed=45)[0]
    e = engine.LLMEngine(config.EngineConfig(model=model, model_config=cfg,
                                             seed=0),
                         params=host, mesh=mesh, device="cpu")
    before = e.generate(prompt, sp, drive=True)
    swap = e.update_weights(1, new)
    after = e.generate(prompt, sp, drive=True)
    fresh = engine.LLMEngine(config.EngineConfig(
        model=model, model_config=cfg, seed=0), params=new, mesh=mesh,
        device="cpu").generate(prompt, sp, drive=True)
    out["swap"] = {"before_logprobs": before["logprobs"],
                   "after": after["token_ids"],
                   "after_logprobs": after["logprobs"],
                   "version": after["weight_version"],
                   "fresh": fresh["token_ids"],
                   "dropped": swap["registrations_dropped"],
                   "qkv_local": tuple(
                       e.runner.params["blocks"]["attn_qkv"]["kernel"]
                       .to_local().shape)}
    return out


def _jax_params():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2, llama

    g = dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=jnp.float32,
                            remat=False)
    return {"gpt2": jax.tree.map(np.asarray, gpt2.init_gpt2(
                jax.random.PRNGKey(0), g)),
            # the weights update_weights installs
            "gpt2_new": jax.tree.map(np.asarray, gpt2.init_gpt2(
                jax.random.PRNGKey(1), g)),
            "llama": jax.tree.map(np.asarray, llama.init_llama(
                jax.random.PRNGKey(0), llama.LlamaConfig.tiny()))}


def _jax_runs(params, ways):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2, llama
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.serve.llm import config, engine

    mesh = build_mesh(MeshSpec(tensor=ways, data=1),
                      devices=jax.devices()[:ways])
    cfgs = {"gpt2": dataclasses.replace(gpt2.GPT2Config.tiny(),
                                        dtype=jnp.float32, remat=False),
            "llama": llama.LlamaConfig.tiny()}
    out = {}
    for model in MODELS:
        for mode in MODES:
            e = engine.LLMEngine(config.EngineConfig(
                model=model, model_config=cfgs[model], **_engine_kw(mode)),
                params=params[model], mesh=mesh)
            out[(model, mode)] = _run_case(e, config,
                                           cfgs[model].vocab_size, mode)
    cfg = cfgs["gpt2"]
    prompt = _prompts(cfg.vocab_size, SWAP_PROMPT, seed=45)[0]
    sp = config.SamplingParams(max_tokens=6, logprobs=True)
    fresh = engine.LLMEngine(config.EngineConfig(
        model="gpt2", model_config=cfg, seed=0),
        params=params["gpt2_new"], mesh=mesh).generate(
        prompt, sp, drive=True)
    out["swap"] = {"after": fresh["token_ids"],
                   "after_logprobs": fresh["logprobs"]}
    return out


@pytest.fixture(scope="module", params=WAYS, ids=lambda w: f"tensor{w}")
def runs(request, tmp_path_factory):
    ways = request.param
    params = _jax_params()
    ranks, want = run_ranks(
        _serve_body, tmp_path_factory.mktemp(f"serve{ways}"), params,
        world=ways, meanwhile=lambda: _jax_runs(params, ways))
    return ways, ranks, want


CASES = [(m, mode) for m in MODELS for mode in MODES]


@pytest.mark.parametrize("model,mode", CASES)
def test_streams_match_the_jax_engine_on_the_same_mesh(runs, model, mode):
    _, ranks, want = runs
    got, ref = ranks[0][(model, mode)], want[(model, mode)]
    for gw, ww in zip(got["waves"], ref["waves"]):
        for i, (g, w) in enumerate(zip(gw, ww)):
            for key in ("token_ids", "finish_reason", "cached_tokens",
                        "preemptions"):
                assert g[key] == w[key], (i, key)
            np.testing.assert_allclose(g["logprobs"], w["logprobs"],
                                       atol=ATOL)
    assert got["stats"] == ref["stats"] and got["pool"] == ref["pool"]
    assert got["stats"]["blocks_used"] == 0 and got["stats"]["running"] == 0
    if mode == "spec":
        assert got["stats"]["spec_accepted"] > 0
    else:
        assert got["stats"]["prefix_hit_pages"] >= 3


@pytest.mark.parametrize("model,mode", CASES)
def test_every_rank_serves_the_same_streams(runs, model, mode):
    _, ranks, _ = runs
    first = ranks[0][(model, mode)]
    for r in ranks[1:]:
        assert r[(model, mode)]["waves"] == first["waves"]
        assert r[(model, mode)]["stats"] == first["stats"]


@pytest.mark.parametrize("model,mode", CASES)
def test_attention_runs_on_each_ranks_heads(runs, model, mode):
    """K1 (monolithic prefill) and the paged or dense attention over the
    cache see this rank's share of the 4 query heads when the KV heads
    divide over tensor; Llama tiny's 2 KV heads at tensor=4 are
    replicated, and the attention over them takes all 4 heads."""
    ways, ranks, _ = runs
    heads = ranks[0][(model, mode)]["heads"]
    replicated = model == "llama" and ways == 4
    cache_heads = [4] if replicated else [4 // ways]
    assert heads["_fwd_plain"] == [4 // ways]
    if mode == "defaults":
        assert "paged_attention_reference" not in heads
        assert heads["_context_attention"] == cache_heads
        assert heads["_context_decode_attention"] == cache_heads
    else:
        assert heads["paged_attention_reference"] == cache_heads


@pytest.mark.parametrize("model,mode", CASES)
def test_one_decode_steps_collectives(runs, model, mode):
    """One decode step's collectives (CommDebugMode) over the two
    layers: an all-reduce after each row-parallel projection (two a
    layer); all-gathers of the vocab-sharded embedding and of the logits
    before sampling; GPT-2's fused qkv gathered at its q|k|v split (one
    a layer); for Llama at tensor=4 its two KV heads' projections (the
    uneven split) and q (the replicated attention), three a layer."""
    ways, ranks, _ = runs
    L = 2
    gathers = {"gpt2": L + 2, "llama": 2 if ways == 2 else 3 * L + 2}
    assert ranks[0][(model, mode)]["decode_collectives"] == {
        "all_gather": gathers[model], "allreduce": 2 * L}


def test_update_weights_on_the_mesh_equals_a_fresh_engine(runs):
    _, ranks, want = runs
    for r in ranks:
        sw = r["swap"]
        assert sw["version"] == 1 and sw["dropped"] > 0
        assert sw["after"] == sw["fresh"] == want["swap"]["after"]
        # the random tiny models repeat the prompt's last token under
        # either weights; their logprobs tell the weights apart
        assert np.abs(np.subtract(sw["after_logprobs"],
                                  sw["before_logprobs"])).max() > 1e-3
        np.testing.assert_allclose(sw["after_logprobs"],
                                   want["swap"]["after_logprobs"], atol=ATOL)


def test_params_are_laid_out_over_tensor(runs):
    """GPT-2's fused qkv kernel (L, E, 3E) is P(None, fsdp, tensor): its
    columns split over the tensor ranks."""
    ways, ranks, _ = runs
    assert ranks[0]["swap"]["qkv_local"] == (2, 128, 3 * 128 // ways)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("ways", [1, 2, 3, 4])
def test_pool_sizing_follows_jax_with_tensor_ways(model, ways, monkeypatch):
    """At 80 GB and 0.3 of it for KV, the small presets' pools per rank:
    a block costs a rank its share of the KV heads when they divide over
    tensor_ways, all of them otherwise."""
    import torch

    from ray_tpu.serve.llm import cache as jax_cache
    from ray_tpu_torch.serve.llm import cache as t_cache

    total = 80 * 10**9
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            total_memory=total))
    kv = {"gpt2": 12, "llama": 4}[model]
    kw = dict(n_layer=12, n_kv_head=kv, head_dim=64, block_size=16,
              dtype_bytes=2, max_model_len=1024, max_batch_size=8,
              memory_fraction=0.3, tensor_ways=ways)
    device = types.SimpleNamespace(
        memory_stats=lambda: {"bytes_limit": total})
    got = t_cache.auto_num_blocks(**kw, device="cuda")
    assert got == jax_cache.auto_num_blocks(**kw, device=device)
    per_rank = kv // ways if kv % ways == 0 else kv
    assert got == int(total * 0.3) // (2 * 12 * 16 * per_rank * 64 * 2)
