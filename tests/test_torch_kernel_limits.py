"""The kernels' limits, named at engine construction: the pure limit
functions of ops/flash_attention.py (K1-K3) and ops/paged_attention.py
(K4) on every shape they refuse and on the new ones they take (head dim
32; 64- and 128-token pages), the runner's check, which raises on a
CUDA device before anything reaches the card, and the CPU, whose plain
versions take every shape: a CPU engine on 64-token pages through K4's
plain version serves the same greedy streams as the JAX engine."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.serve.llm import config as jax_config
from ray_tpu.serve.llm import engine as jax_engine
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.ops import paged_attention as t_paged
from ray_tpu_torch.serve.llm import config as t_config
from ray_tpu_torch.serve.llm import engine as t_engine
from ray_tpu_torch.serve.llm import runner as t_runner

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("shape,named", [
    ((24, 64, 1, 1, BF16), "page size"),
    ((256, 64, 1, 1, F32), "page size"),
    ((16, 48, 1, 1, BF16), "head dim"),
    ((16, 256, 1, 1, F32), "head dim"),
    ((16, 64, 33, 1, BF16), "window W=33"),
    ((16, 64, 0, 1, BF16), "window W=0"),
    ((16, 64, 1, 1, torch.float16), "dtype"),
    ((16, 128, 32, 8, F32), "shared memory"),
    ((128, 128, 32, 4, F32), "shared memory"),
])
def test_paged_limit_names_what_k4_refuses(shape, named):
    limit = t_paged.kernel_limit(*shape)
    assert limit is not None and named in limit, limit


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_paged_limit_takes_the_new_shapes(bs, D, dtype):
    """Head dim 32 and 64- and 128-token pages at decode (W=1) and a
    verify window of four drafts (W=5), for GPT-2's and Llama-small's
    heads; a 128-token f32 page at D=128 fits because the ring holds
    tiles of 32 rows, not pages."""
    for window, group in ((1, 1), (5, 1), (1, 3), (5, 3)):
        assert t_paged.kernel_limit(bs, D, window, group, dtype, 64) is None
    tile = min(bs, 32)
    assert t_paged.smem_bytes(1, D, bs, 4, 64) == t_paged.smem_bytes(
        1, D, tile, 4, 64)


@pytest.mark.parametrize("D,dtype,named", [
    (48, BF16, "head dim 48"), (16, F32, "head dim 16"),
    (256, BF16, "head dim 256"), (64, torch.float16, "dtype")])
def test_flash_limit_names_what_k1_refuses(D, dtype, named):
    limit = t_flash.kernel_limit(D, dtype)
    assert limit is not None and named in limit, limit


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_limit_takes_head_dim_32(D, dtype):
    assert t_flash.kernel_limit(D, dtype) is None


def _limit(cfg, *, block_size=16, max_model_len=128, draft=0, paged=True,
           kv_heads=None):
    return t_runner.kernel_limit(
        cfg, kv_heads or getattr(cfg, "n_kv_head", cfg.n_head),
        block_size=block_size,
        max_blocks_per_seq=-(-max_model_len // block_size),
        spec_width=draft + 1 if draft else 0, use_paged_attention=paged)


def test_runner_limit_covers_prefill_decode_and_verify():
    """The tiny presets (D=32) now pass; a window past K4's, a page size
    it refuses and a head dim K1 refuses are each named, with the path
    that would launch the kernel. Without paged attention only K1's
    limit applies."""
    for cfg in (t_gpt2.GPT2Config.tiny(), t_llama.LlamaConfig.tiny(),
                t_gpt2.GPT2Config.small(), t_llama.LlamaConfig.small()):
        for bs in (16, 64, 128):
            assert _limit(cfg, block_size=bs, draft=4) is None
    tiny = t_gpt2.GPT2Config.tiny()
    limit = _limit(tiny, draft=40)
    assert "speculative verify" in limit and "W=41" in limit
    assert "page size" in _limit(tiny, block_size=24)
    assert _limit(tiny, block_size=24, draft=40, paged=False) is None
    odd = dataclasses.replace(tiny, n_head=8, n_embd=384)  # D = 48
    assert "flash kernel (K1)" in _limit(odd, paged=False)


@pytest.mark.parametrize("over,named", [
    ({"speculative": {"num_draft_tokens": 40},
      "use_paged_attention": True}, "W=41"),
    ({"block_size": 24, "use_paged_attention": True}, "page size"),
])
def test_runner_on_cuda_refuses_at_construction(over, named):
    """On a CUDA device the runner checks before it allocates anything:
    the refusal comes from construction, not from a first step, and
    needs no card to be seen."""
    cfg = t_config.EngineConfig(model="gpt2", preset="tiny", **over)
    spec = cfg.speculative
    tcfg = t_gpt2.GPT2Config.tiny()
    with pytest.raises(ValueError, match=named):
        t_runner.ModelRunner(
            t_runner.adapters()["gpt2"], tcfg, None,
            block_size=cfg.block_size, num_blocks=64, max_model_len=128,
            max_batch_size=4, device=torch.device("cuda"),
            num_draft_tokens=spec.num_draft_tokens if spec else 0,
            use_paged_attention=cfg.use_paged_attention)


def test_cpu_engine_takes_shapes_the_kernels_refuse():
    """The plain versions take any shape, so a CPU engine builds and
    serves where the card would refuse."""
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), dtype=F32)
    gen = torch.Generator().manual_seed(0)
    te = t_engine.LLMEngine(t_config.EngineConfig(
        model_config=tcfg, block_size=24, num_blocks=32, max_model_len=96,
        use_paged_attention=True, speculative={"num_draft_tokens": 40}),
        params=t_gpt2.init_gpt2(gen, tcfg, device="cpu"), device="cpu")
    out = te.generate([5, 6, 7, 5, 6, 7], t_config.SamplingParams(
        max_tokens=6), drive=True)
    assert out["num_generated"] == 6


def test_paged_engine_on_64_token_pages_matches_jax():
    """GPT-2 tiny in f32 on 64-token pages, paged decode through K4's
    plain version on the CPU and the JAX engine's paged kernel: the
    same greedy streams, and the pool drains."""
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dtype=jnp.float32,
                               remat=False)
    tcfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), dtype=F32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    kw = dict(model="gpt2", block_size=64, num_blocks=16, max_model_len=128,
              max_batch_size=4, prefill_chunk_size=0,
              use_paged_attention=True, seed=0)
    je = jax_engine.LLMEngine(jax_config.EngineConfig(model_config=jcfg,
                                                      **kw), params=jp)
    te = t_engine.LLMEngine(t_config.EngineConfig(model_config=tcfg, **kw),
                            params=interop.params_from_jax(jp),
                            device="cpu")
    prompts = [[3 + i for i in range(n)] for n in (70, 9, 33)]
    finals = []
    for engine, mod in ((je, jax_config), (te, t_config)):
        sp = mod.SamplingParams(max_tokens=10)
        streams = [engine.add_request(p, sp) for p in prompts]
        for _ in range(500):
            if all(s.final() is not None for s in streams):
                break
            engine.step()
        finals.append([s.final()["token_ids"] for s in streams])
    assert finals[0] == finals[1]
    assert all(len(t) == 10 for t in finals[1])
    assert te.stats()["blocks_used"] == 0
