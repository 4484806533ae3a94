"""GPT-2 in PyTorch: the port of ``ray_tpu/models/gpt2.py``.

Parameters are a nested dict of tensors with the JAX tree's names and
layout (``wte``, ``wpe``, ``blocks`` with stacked ``[L, ...]`` leaves
``ln1``, ``attn_qkv``, ``attn_proj``, ``ln2``, ``mlp_fc``, ``mlp_proj``,
and ``lnf``; dense kernels ``(in, out)``), so `ray_tpu_torch.interop`
maps a JAX tree one to one. Masters are float32; compute runs in
``cfg.dtype``, with the same casts as the JAX model: matmul kernels,
biases and embeddings go to ``cfg.dtype``, layer norms run in f32 with
f32 scale and bias. `serving_params` makes those casts once; a cast of
a float32 tensor to bf16 rounds to nearest even in both frameworks, so
its copies are bit-equal to JAX's per-call ``.astype(dt)``.

Attention goes through ``ops/attention.py`` (kernel K1 forward, K2 and
K3 backward) in the full-sequence forward and monolithic prefill, and
through ``ops/paged_attention.py`` (kernel K4) in paged decode and the
speculative verify window. Chunked prefill and dense decode attend over
a gathered context with the JAX model's plain einsum math, which runs
outside any kernel there too. Every serving path shares the block's
projections and MLP; the paged ones swap the attention core through
the JAX model's ``attend`` hook. `gpt2_loss` is the training loss; with
``cfg.remat`` (the default) each block of `gpt2_forward` runs under
``torch.utils.checkpoint`` with the JAX model's RAY_TPU_REMAT_POLICY:
"full" recomputes the block in the backward, "save_flash" keeps the
flash operator's (o, lse), "save_dots" also every matmul output without
batch dims (``aten.mm``, ``aten.addmm``), "none" keeps everything.

On a mesh the params are DTensors laid out by `gpt2_partition_rules`
(Megatron columns and rows over "tensor", the other matmul dim over
"fsdp") and the batch is sharded over ("data", "fsdp"); the block
constrains its activations where the JAX forward does
(``parallel.sharding.constrain``, a no-op on plain tensors:
(batch, None, last) for a (B, T, E) activation, (batch, last) for a
decode step's (B, E)), and the constants it makes (positions, the vocab
mask) are lifted onto the params' mesh as replicated DTensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import (
    causal_attention,
    context_attention,
    context_decode_attention,
)
from ray_tpu_torch.ops.paged_attention import decode_hook, window_hook
from ray_tpu_torch.parallel.sharding import (
    PartitionRules,
    PartitionSpec as P,
    batch_spec,
    constrain,
    replicate_like,
)
from ray_tpu_torch.util import tree

Params = Any
_DENSE = ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    dtype: torch.dtype = torch.bfloat16
    # Pad the vocab so the logits matmul tiles cleanly (50257 -> 50304
    # for gpt2-small).
    vocab_pad_multiple: int = 128
    remat: bool = True

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config(n_layer=24, n_head=16, n_embd=1024)

    @staticmethod
    def large() -> "GPT2Config":
        return GPT2Config(n_layer=36, n_head=20, n_embd=1280)

    @staticmethod
    def xl() -> "GPT2Config":
        return GPT2Config(n_layer=48, n_head=25, n_embd=1600)

    @staticmethod
    def tiny(vocab_size: int = 512, block_size: int = 128) -> "GPT2Config":
        return GPT2Config(
            vocab_size=vocab_size,
            n_layer=2,
            n_head=4,
            n_embd=128,
            block_size=block_size,
            vocab_pad_multiple=128,
        )


def gpt2_partition_rules() -> PartitionRules:
    """Megatron-style sharding, as the JAX model's rules. Stacked block
    params have a leading layer dim (None). Column-parallel: qkv / mlp
    fc shard the output dim on 'tensor'; row-parallel: attn proj / mlp
    proj shard the input dim on 'tensor'. 'fsdp' shards the other matmul
    dim (ZeRO-3-style)."""
    return PartitionRules(
        [
            (r"wte$", P("tensor", "fsdp")),
            (r"wpe$", P(None, "fsdp")),
            (r"attn_qkv/kernel$", P(None, "fsdp", "tensor")),
            (r"attn_proj/kernel$", P(None, "tensor", "fsdp")),
            (r"mlp_fc/kernel$", P(None, "fsdp", "tensor")),
            (r"mlp_proj/kernel$", P(None, "tensor", "fsdp")),
            (r"attn_qkv/bias$", P(None, "tensor")),
            (r"mlp_fc/bias$", P(None, "tensor")),
            # layer norms, row-parallel biases: replicated
            (r".*", P()),
        ]
    )


def init_gpt2(generator: torch.Generator, cfg: GPT2Config,
              device: str | torch.device | None = None) -> Params:
    """Initialize parameters (float32 master copy) on `device` (None:
    "cuda"; "cpu" must be asked for), GPT-2 init scheme: normal(0.02),
    residual projections scaled by 1/sqrt(2*n_layer), biases zero, layer
    norms one/zero. The draws are made on the generator's device and then
    moved, so one seeded generator gives the same params on either
    device. They follow torch's generator, not jax.random: the tests
    convert JAX parameters through `interop` instead of re-initialising."""
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.padded_vocab
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_gpt2: the params go to the card by default, and no card "
            "is available; pass device='cpu' to make them on the CPU")
    std = 0.02
    resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    blocks = {
        "ln1": {"scale": ones(L, E), "bias": zeros(L, E)},
        "attn_qkv": {"kernel": normal((L, E, 3 * E), std),
                     "bias": zeros(L, 3 * E)},
        "attn_proj": {"kernel": normal((L, E, E), resid_std),
                      "bias": zeros(L, E)},
        "ln2": {"scale": ones(L, E), "bias": zeros(L, E)},
        "mlp_fc": {"kernel": normal((L, E, 4 * E), std),
                   "bias": zeros(L, 4 * E)},
        "mlp_proj": {"kernel": normal((L, 4 * E, E), resid_std),
                     "bias": zeros(L, E)},
    }
    return {
        "wte": normal((V, E), std),
        "wpe": normal((cfg.block_size, E), std),
        "blocks": blocks,
        "lnf": {"scale": ones(E), "bias": zeros(E)},
    }


def serving_params(params: Params, cfg: GPT2Config) -> Params:
    """The tree with every leaf the model casts to ``cfg.dtype`` cast
    once (embeddings, dense kernels and biases); layer norms stay f32."""
    dt = cfg.dtype
    blocks = dict(params["blocks"])
    for name in _DENSE:
        blocks[name] = {k: t.to(dt) for k, t in blocks[name].items()}
    return {"wte": params["wte"].to(dt), "wpe": params["wpe"].to(dt),
            "blocks": blocks, "lnf": params["lnf"]}


def _layer_norm(x, scale, bias, eps=1e-5):
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def _dense(h, p, dt):
    return h @ p["kernel"].to(dt) + p["bias"].to(dt)


def _mlp(x, p, cfg: GPT2Config):
    h = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = _dense(h, p["mlp_fc"], cfg.dtype)
    h = constrain(h, *batch_spec(h.ndim, "tensor"))
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    h = F.gelu(h, approximate="tanh")
    return x + constrain(_dense(h, p["mlp_proj"], cfg.dtype),
                         *batch_spec(x.ndim))


def _attn_out(x, att, p, cfg: GPT2Config):
    """The rest of a block after its attention core: output projection,
    residual, MLP (shared by every serving path, as in the JAX model)."""
    x = x + constrain(_dense(att, p["attn_proj"], cfg.dtype),
                      *batch_spec(x.ndim))
    return _mlp(x, p, cfg)


def _qkv(x, p, cfg: GPT2Config):
    """ln1 and the fused projection of x (..., E) -> q, k, v (..., H, D),
    column slices of one tensor."""
    E = cfg.n_embd
    h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    qkv = constrain(_dense(h, p["attn_qkv"], cfg.dtype),
                    *batch_spec(h.ndim, "tensor"))
    return (t.reshape(*x.shape[:-1], cfg.n_head, cfg.head_dim)
            for t in qkv.split(E, dim=-1))


def _block_kv(x, p, cfg: GPT2Config):
    """One transformer block on x (B, T, E); also returns this layer's
    attention K/V heads (B, T, H, D) for the serving cache."""
    B, T, E = x.shape
    q, k, v = _qkv(x, p, cfg)
    att = causal_attention(q, k, v).reshape(B, T, E)
    return _attn_out(x, att, p, cfg), (k, v)


def _block(x, p, cfg: GPT2Config):
    return _block_kv(x, p, cfg)[0]


def _saved_ops(mode: str) -> frozenset:
    """The operators whose outputs a selective remat policy keeps: the
    flash operator's (o, lse) (JAX: ``save_only_these_names("flash_o",
    "flash_lse")``), and under "save_dots" every matmul without batch
    dims (JAX: ``dots_with_no_batch_dims_saveable``), which in torch are
    the 2-D ``aten.mm`` and ``aten.addmm`` that a (B, T, E) @ (E, N)
    product folds into; a batched ``aten.bmm`` is recomputed."""
    ops = {torch.ops.ray_tpu_torch.flash_fwd.default}
    if mode == "save_dots":
        ops |= {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    return frozenset(ops)


def _policy_contexts(saved: frozenset):
    """A fresh pair of selective-checkpoint contexts that keep `saved`'s
    outputs and recompute everything else."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _remat_block(cfg: GPT2Config):
    """The block as `gpt2_forward` runs it. With ``cfg.remat`` and under
    grad, RAY_TPU_REMAT_POLICY picks what the backward replay reuses, as
    in the JAX model: "none" keeps every activation; "save_flash" and
    "save_dots" keep the outputs of `_saved_ops` and recompute the rest;
    any other value is "full" and recomputes the whole block. All run
    ``torch.utils.checkpoint`` non-reentrant."""
    if not cfg.remat:
        return _block
    mode = os.environ.get("RAY_TPU_REMAT_POLICY", "full")
    if mode == "none" or not torch.is_grad_enabled():
        return _block
    # the block draws no random numbers, so no RNG state is stashed
    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    if mode in ("save_flash", "save_dots"):
        kwargs["context_fn"] = functools.partial(_policy_contexts,
                                                 _saved_ops(mode))
    return functools.partial(checkpoint, _block, **kwargs)


def _embed(params, tokens, positions, cfg: GPT2Config):
    dt = cfg.dtype
    # the vocab-sharded table is gathered whole before the lookup, as in
    # the JAX model
    wte = constrain(params["wte"].to(dt), None, None)
    x = wte[tokens] + params["wpe"].to(dt)[positions]
    return constrain(x, *batch_spec(x.ndim))


def _logits(params, x, cfg: GPT2Config):
    x = _layer_norm(x, params["lnf"]["scale"], params["lnf"]["bias"])
    logits = x @ params["wte"].to(cfg.dtype).T
    return constrain(logits, *batch_spec(logits.ndim, "tensor")).float()


def gpt2_forward(params: Params, tokens: torch.Tensor,
                 cfg: GPT2Config) -> torch.Tensor:
    """tokens (B, T) int -> logits (B, T, padded_vocab) float32."""
    T = tokens.shape[1]
    block = _remat_block(cfg)
    positions = replicate_like(torch.arange(T, device=tokens.device),
                               params["wpe"])
    x = _embed(params, tokens, positions, cfg)
    for p in tree.unstack(params["blocks"]):
        x = block(x, p, cfg)
    return _logits(params, x, cfg)


def gpt2_loss(params: Params, batch: dict, cfg: GPT2Config) -> torch.Tensor:
    """Next-token cross entropy; positions past vocab_size are masked.
    `batch` holds ``tokens`` and ``targets`` (B, T) and optionally
    ``weights`` (B, T), which average the per-token losses."""
    logits = gpt2_forward(params, batch["tokens"], cfg)
    V = cfg.padded_vocab
    mask = replicate_like(torch.arange(V, device=logits.device),
                          logits) < cfg.vocab_size
    logits = torch.where(mask, logits, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    weights = batch.get("weights")
    if weights is None:
        return -ll.mean()
    weights = weights.to(ll.dtype)
    return -(ll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def gpt2_prefill_kv(params: Params, tokens: torch.Tensor, cfg: GPT2Config
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B, T) -> (logits (B, T, Vp) f32, k, v (L, B, T, H, D))."""
    T = tokens.shape[1]
    x = _embed(params, tokens, torch.arange(T, device=tokens.device), cfg)
    x, k, v = tree.scan_layers(params["blocks"], x,
                               lambda i, p, x: _block_kv(x, p, cfg))
    return _logits(params, x, cfg), k, v


def _chunk_block(x, p, k_ctx, v_ctx, ctx_mask, chunk_mask, cfg: GPT2Config,
                 attend=None):
    """Chunked-prefill block step. x (B, T, E) holds a chunk of the
    sequence at absolute positions start..start+T-1; k_ctx/v_ctx
    (B, C, H, D) hold the cached context for positions < start (ctx_mask
    (B, C) marks valid slots); chunk_mask (B, T) marks the chunk's real
    positions. Returns (x, (k, v)) with k/v (B, T, H, D), the chunk's
    cache contribution.

    With ``attend`` set (the paged path) the dense context math is
    replaced by ``attend(q, k, v) -> (B, T, H, D)``, which reads this
    layer's pages itself; projections and MLP stay shared."""
    B, T, E = x.shape
    q, k, v = _qkv(x, p, cfg)
    if attend is not None:
        att = attend(q, k, v)
    else:
        att = context_attention(q, k, v, k_ctx, v_ctx, ctx_mask,
                                chunk_mask)
    return _attn_out(x, att.reshape(B, T, E), p, cfg), (k, v)


def _chunk_positions(start: int, T: int, block_size: int, device):
    """Absolute positions start..start+T-1, clipped to the position
    range. Gathered by, never sliced: a slice would clamp its start when
    bucket padding runs past n_positions and shift every real token's
    embedding; only padded tail rows clip, and their K/V lands in the
    null page."""
    return (start + torch.arange(T, device=device)).clamp(0, block_size - 1)


def gpt2_prefill_chunk_kv(params: Params, tokens: torch.Tensor, start: int,
                          k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                          ctx_mask: torch.Tensor, chunk_mask: torch.Tensor,
                          cfg: GPT2Config
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Prefill a chunk from a position offset. tokens (B, T) sit at
    absolute positions start..start+T-1; k_ctx/v_ctx (L, B, C, H, D)
    hold the gathered context for positions < start, ctx_mask (B, C)
    its valid slots and chunk_mask (B, T) the chunk's real tokens.
    Returns (logits (B, T, Vp) f32, k, v (L, B, T, H, D)); the caller
    scatters k/v into the pages."""
    def step(i, p, x):
        return _chunk_block(x, p, k_ctx[i], v_ctx[i], ctx_mask,
                            chunk_mask, cfg)

    pos = _chunk_positions(start, tokens.shape[1], cfg.block_size,
                           tokens.device)
    x = _embed(params, tokens, pos, cfg)
    x, k, v = tree.scan_layers(params["blocks"], x, step)
    return _logits(params, x, cfg), k, v


def _decode_block(x, p, k_ctx, v_ctx, ctx_mask, cfg: GPT2Config,
                  attend=None):
    """Single-token block step. x (B, E); k_ctx/v_ctx (B, C, H, D) hold
    the cached context (ctx_mask (B, C) marks valid slots). Returns
    (x, (k_new, v_new)) with k_new/v_new (B, H, D). ``attend(q, k, v)
    -> (B, H, D)`` swaps in the paged kernel (see `_chunk_block`)."""
    B, E = x.shape
    q, k, v = _qkv(x, p, cfg)
    if attend is not None:
        att = attend(q, k, v)
    else:
        att = context_decode_attention(q, k, v, k_ctx, v_ctx, ctx_mask)
    return _attn_out(x, att.reshape(B, E), p, cfg), (k, v)


def gpt2_decode_kv(params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, k_ctx: torch.Tensor,
                   v_ctx: torch.Tensor, ctx_mask: torch.Tensor,
                   cfg: GPT2Config
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense decode step. tokens/positions (B,); k_ctx/v_ctx
    (L, B, C, H, D) the gathered context; ctx_mask (B, C). Returns
    (logits (B, Vp) f32, k_new, v_new (L, B, H, D)); the caller
    scatters k_new/v_new at each sequence's position."""
    def step(i, p, x):
        return _decode_block(x, p, k_ctx[i], v_ctx[i], ctx_mask, cfg)

    x = _embed(params, tokens, positions.long(), cfg)
    x, k, v = tree.scan_layers(params["blocks"], x, step)
    return _logits(params, x, cfg), k, v


def gpt2_decode_paged_kv(params: Params, tokens: torch.Tensor,
                         positions: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, tables: torch.Tensor,
                         cfg: GPT2Config
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the page pool (L, num_blocks, block_size,
    H, D) through kernel K4. tokens/positions (B,) with positions int32
    (it is also the kernel's ctx_len); tables (B, max_blocks_per_seq)
    int32. Returns (logits (B, Vp) f32, k_new, v_new (L, B, H, D)); the
    caller scatters k_new/v_new into the pages after the step."""
    def step(i, p, x):
        return _decode_block(x, p, None, None, None, cfg, attend=decode_hook(
            k_pages[i], v_pages[i], tables, positions))

    x = _embed(params, tokens, positions.long(), cfg)
    x, k, v = tree.scan_layers(params["blocks"], x, step)
    return _logits(params, x, cfg), k, v


def gpt2_verify_paged_kv(params: Params, tokens: torch.Tensor, start: int,
                         k_pages: torch.Tensor, v_pages: torch.Tensor,
                         table: torch.Tensor, cfg: GPT2Config
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Speculative verify window against the page pool: tokens (1, W) at
    absolute positions start..start+W-1, table (max_blocks_per_seq,)
    int32 covering cached positions < start, through kernel K4 with
    ctx_len = start. Causal within the window (no chunk mask: a row only
    attends rows before it, and rows past the draft count are discarded
    by the caller). Returns (logits (1, W, Vp) f32, k, v
    (L, 1, W, H, D))."""
    dev = tokens.device
    pos = _chunk_positions(start, tokens.shape[1], cfg.block_size, dev)
    x = _embed(params, tokens, pos, cfg)
    tables = table[None]
    ctx_len = torch.full((1,), start, dtype=torch.int32, device=dev)

    def step(i, p, x):
        return _chunk_block(x, p, None, None, None, None, cfg,
                            attend=window_hook(k_pages[i], v_pages[i],
                                               tables, ctx_len))

    x, k, v = tree.scan_layers(params["blocks"], x, step)
    return _logits(params, x, cfg), k, v


def count_params(params: Params) -> int:
    return sum(t.numel() for t in tree.leaves(params))
