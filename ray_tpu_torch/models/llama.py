"""Llama in PyTorch: the port of ``ray_tpu/models/llama.py``.

RMSNorm, half-split rotary embeddings, SwiGLU and grouped-query
attention (n_kv_head <= n_head). Parameters are a nested dict of
tensors with the JAX tree's names and layout (``wte``, ``blocks`` with
stacked ``[L, ...]`` leaves ``ln_attn``, ``wq``, ``wk``, ``wv``, ``wo``,
``ln_mlp``, ``w_gate``, ``w_up``, ``w_down``, and ``lnf``; dense
kernels ``(in, out)``, no biases), so `ray_tpu_torch.interop` maps a JAX
tree one to one. Masters are float32; compute runs in ``cfg.dtype``
with the JAX model's casts (matmul kernels and the embedding to
``cfg.dtype``, the norms in f32 with f32 scales); `serving_params`
makes those casts once.

The cache holds K after the rotary embedding and before the grouped
heads are repeated, (B, T, H_kv, D). Monolithic prefill repeats K/V up
to n_head (``repeat_interleave``, the order of ``jnp.repeat``) and
attends through kernel K1 (``ops/attention.py``); paged decode and the
speculative verify window attend through kernel K4, which maps query
head h to KV head h // (H / H_kv) itself; chunked prefill and dense
decode use the JAX model's plain einsum math over the gathered context,
outside any kernel there too. Every serving path shares the block's
projections and MLP through the JAX model's ``attend`` hook.

The rotary angles are computed once per call for the positions it
covers, in f32, as ``theta ** (-arange(half) / half)`` times the
position, then applied in f32 and cast to the activation dtype; prefill,
chunk and decode share that code, so a position's K agrees bit for bit
on every path. `llama_forward` is the training forward: with
``cfg.remat`` and under grad each block is recomputed in the backward
(``torch.utils.checkpoint``, as the JAX model's ``jax.checkpoint`` over
each block; the JAX Llama reads no RAY_TPU_REMAT_POLICY, and neither
does this one), and K/V are repeated to the query heads before K1, so
the GQA gradient sums each group's dk/dv through ``repeat_interleave``'s
own backward. `llama_loss` is its next-token loss.

On a mesh the params are DTensors laid out by `llama_partition_rules`,
the block constrains its activations where the JAX training forward
does (``parallel.sharding.constrain``, a no-op on plain tensors),
and the rotary angles and the vocab mask are
lifted onto the params' mesh as replicated DTensors. wq, wk and wv are
separate column-parallel kernels, so under a tensor axis the heads
reach the attention kernels sharded: K1 runs on H / tensor heads a
rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    unflatten_heads,
)
from ray_tpu_torch.util import tree

Params = Any
_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 8
    n_head: int = 8
    n_kv_head: int = 4  # grouped-query attention
    n_embd: int = 512
    intermediate: int = 1408  # SwiGLU hidden (~8/3 * n_embd, 128-aligned)
    block_size: int = 1024
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2,
                           n_embd=128, intermediate=384, block_size=128,
                           dtype=torch.float32, remat=False)

    @staticmethod
    def small() -> "LlamaConfig":
        """~110M-param config comparable to GPT-2-small."""
        return LlamaConfig(vocab_size=32000, n_layer=12, n_head=12,
                           n_kv_head=4, n_embd=768, intermediate=2048,
                           block_size=1024)


def llama_partition_rules() -> PartitionRules:
    """Megatron layout over the canonical axes, as the JAX model's rules:
    attention/MLP input projections sharded on the output dim over
    'tensor', output projections on the input dim; embeddings
    vocab-sharded; everything fsdp-sharded on the other dim. Block
    params are stacked: the leading layer dim stays unsharded."""
    return PartitionRules([
        (r"blocks/(wq|wk|wv)$", P(None, "fsdp", "tensor")),
        (r"blocks/wo$", P(None, "tensor", "fsdp")),
        (r"blocks/(w_gate|w_up)$", P(None, "fsdp", "tensor")),
        (r"blocks/w_down$", P(None, "tensor", "fsdp")),
        (r"blocks/(ln_attn|ln_mlp)$", P()),
        (r"wte$", P("tensor", "fsdp")),
        (r"lnf$", P()),
        (r".*", P()),
    ])


def init_llama(generator: torch.Generator, cfg: LlamaConfig,
               device: str | torch.device | None = None) -> Params:
    """Initialize parameters (float32 master copy) on `device` (None:
    "cuda"; "cpu" must be asked for): normal(0.02), output projections
    scaled by 1/sqrt(2 n_layer), norms one. The draws are made on the
    generator's device and then moved; they follow torch's generator,
    not jax.random (tests convert JAX parameters through `interop`)."""
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.padded_vocab
    kv_dim = cfg.n_kv_head * cfg.head_dim
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_llama: the params go to the card by default, and no "
            "card is available; pass device='cpu' to make them on the CPU")
    std = 0.02
    out_std = std / math.sqrt(2 * L)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(dev)

    return {
        "wte": normal((V, E), std),
        "blocks": {
            "ln_attn": torch.ones(L, E, device=dev),
            "wq": normal((L, E, E), std),
            "wk": normal((L, E, kv_dim), std),
            "wv": normal((L, E, kv_dim), std),
            "wo": normal((L, E, E), out_std),
            "ln_mlp": torch.ones(L, E, device=dev),
            "w_gate": normal((L, E, cfg.intermediate), std),
            "w_up": normal((L, E, cfg.intermediate), std),
            "w_down": normal((L, cfg.intermediate, E), out_std),
        },
        "lnf": torch.ones(E, device=dev),
    }


def serving_params(params: Params, cfg: LlamaConfig) -> Params:
    """The tree with the embedding and every dense kernel cast once to
    ``cfg.dtype``; the norms stay f32."""
    dt = cfg.dtype
    blocks = {k: (t.to(dt) if k in _DENSE else t)
              for k, t in params["blocks"].items()}
    return {"wte": params["wte"].to(dt), "blocks": blocks,
            "lnf": params["lnf"]}


def _rmsnorm(x, scale, eps):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, (len(positions), head_dim / 2)
    f32: position times ``theta ** (-arange(half) / half)``."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, cos, sin):
    """The half-split rotation of x's last dim (concatenated halves, not
    interleaved pairs), in f32, cast back to x's dtype; cos/sin
    broadcast against x's halves."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def chunk_rope(start: int, T: int, head_dim: int, theta: float, device):
    """Rotary (cos, sin) of positions start..start+T-1, shaped
    (1, T, 1, D/2) against (B, T, H, D)."""
    pos = start + torch.arange(T, device=device)
    cos, sin = rope_angles(pos, head_dim, theta)
    return cos[None, :, None, :], sin[None, :, None, :]


def decode_rope(positions: torch.Tensor, head_dim: int, theta: float):
    """Rotary (cos, sin) of each sequence's position (B,), shaped
    (B, 1, D/2) against (B, H, D)."""
    cos, sin = rope_angles(positions, head_dim, theta)
    return cos[:, None, :], sin[:, None, :]


def _rope(x, theta: float):
    """Rotary embedding of x (B, T, H, D) at positions 0..T-1."""
    return _rope_chunk(x, 0, theta)


def _rope_at(x, positions, theta: float):
    """Rotary embedding of single-token x (B, H, D), each sequence at its
    own absolute position (B,)."""
    return _rotate(x, *decode_rope(positions, x.shape[-1], theta))


def _rope_chunk(x, start: int, theta: float):
    """Rotary embedding of a chunk x (B, T, H, D) at absolute positions
    start..start+T-1."""
    return _rotate(x, *chunk_rope(start, x.shape[1], x.shape[-1], theta,
                                  x.device))


def _qkv(x, p, rope, cfg: LlamaConfig):
    """RMSNorm and the projections of x (..., E) -> q (..., H, D) and k, v
    (..., H_kv, D), q and k rotated by rope = (cos, sin), each already
    shaped to broadcast against the heads."""
    dt = cfg.dtype
    h = _rmsnorm(x, p["ln_attn"], cfg.rms_eps)
    q = unflatten_heads(h @ p["wq"].to(dt), cfg.n_head, cfg.head_dim)
    k = unflatten_heads(h @ p["wk"].to(dt), cfg.n_kv_head, cfg.head_dim)
    v = unflatten_heads(h @ p["wv"].to(dt), cfg.n_kv_head, cfg.head_dim)
    return _rotate(q, *rope), _rotate(k, *rope), v


def _attn_out(x, att, p, cfg: LlamaConfig):
    """The rest of a block after its attention core: output projection,
    residual, SwiGLU MLP."""
    dt = cfg.dtype
    x = x + constrain(att @ p["wo"].to(dt), *batch_spec(x.ndim))
    h = _rmsnorm(x, p["ln_mlp"], cfg.rms_eps)
    gate = h @ p["w_gate"].to(dt)
    up = h @ p["w_up"].to(dt)
    gate = constrain(gate, *batch_spec(gate.ndim, "tensor"))
    return x + constrain((F.silu(gate) * up) @ p["w_down"].to(dt),
                         *batch_spec(x.ndim))


def _block_kv(x, p, rope, cfg: LlamaConfig):
    """One block on x (B, T, E) from position 0; also returns the cached
    layout of its K/V, post-rope and pre-repetition (B, T, H_kv, D)."""
    B, T, E = x.shape
    q, k, v = _qkv(x, p, rope, cfg)
    rep = cfg.n_head // cfg.n_kv_head
    att = causal_attention(q, k.repeat_interleave(rep, dim=2),
                           v.repeat_interleave(rep, dim=2))
    return _attn_out(x, att.reshape(B, T, E), p, cfg), (k, v)


def _block(x, p, rope, cfg: LlamaConfig):
    return _block_kv(x, p, rope, cfg)[0]


def _chunk_block(x, p, k_ctx, v_ctx, ctx_mask, chunk_mask, rope,
                 cfg: LlamaConfig, attend=None):
    """Chunked-prefill block step (see models/gpt2.py `_chunk_block`):
    x (B, T, E) at absolute positions start..start+T-1, rope their
    angles; k_ctx/v_ctx (B, C, H_kv, D) the post-rope cached context.
    Returns (x, (k, v)) with k/v (B, T, H_kv, D). ``attend(q, k, v) ->
    (B, T, H, D)``, k/v pre-repetition, swaps in the paged kernel."""
    B, T, E = x.shape
    q, k, v = _qkv(x, p, rope, cfg)
    if attend is not None:
        att = attend(q, k, v)
    else:
        att = context_attention(q, k, v, k_ctx, v_ctx, ctx_mask,
                                chunk_mask)
    return _attn_out(x, att.reshape(B, T, E), p, cfg), (k, v)


def _decode_block(x, p, k_ctx, v_ctx, ctx_mask, rope, cfg: LlamaConfig,
                  attend=None):
    """Single-token block step: x (B, E) at each sequence's position,
    rope its angles; k_ctx/v_ctx (B, C, H_kv, D) the post-rope cached
    context, ctx_mask (B, C). Returns (x, (k_new, v_new)) with
    k_new/v_new (B, H_kv, D). ``attend(q, k, v) -> (B, H, D)`` swaps in
    the paged kernel."""
    B, E = x.shape
    q, k, v = _qkv(x, p, rope, cfg)
    if attend is not None:
        att = attend(q, k, v)
    else:
        att = context_decode_attention(q, k, v, k_ctx, v_ctx, ctx_mask)
    return _attn_out(x, att.reshape(B, E), p, cfg), (k, v)


def _embed(params, tokens, cfg: LlamaConfig):
    # the vocab-sharded table is gathered whole before the lookup
    wte = constrain(params["wte"].to(cfg.dtype), None, None)
    return constrain(wte[tokens], *batch_spec(tokens.ndim + 1))


def _logits(params, x, cfg: LlamaConfig):
    x = _rmsnorm(x, params["lnf"], cfg.rms_eps)
    logits = x @ params["wte"].to(cfg.dtype).T
    return constrain(logits, *batch_spec(logits.ndim, "tensor")).float()


def llama_prefill_kv(params: Params, tokens: torch.Tensor,
                     cfg: LlamaConfig
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B, T) -> (logits (B, T, Vp) f32, k, v (L, B, T, H_kv, D)),
    attention through kernel K1."""
    rope = chunk_rope(0, tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                      tokens.device)
    x, k, v = tree.scan_layers(params["blocks"], _embed(params, tokens, cfg),
                               lambda i, p, x: _block_kv(x, p, rope, cfg))
    return _logits(params, x, cfg), k, v


def llama_forward(params: Params, tokens: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, padded_vocab) float32, the training
    forward: with ``cfg.remat`` and under grad each block is recomputed
    in the backward ("full" remat, non-reentrant)."""
    rope = tuple(replicate_like(t, params["wte"]) for t in chunk_rope(
        0, tokens.shape[1], cfg.head_dim, cfg.rope_theta, tokens.device))
    block = _block
    if cfg.remat and torch.is_grad_enabled():
        # the block draws no random numbers, so no RNG state is stashed
        block = functools.partial(checkpoint, _block, use_reentrant=False,
                                  preserve_rng_state=False)
    x = _embed(params, tokens, cfg)
    for p in tree.unstack(params["blocks"]):
        x = block(x, p, rope, cfg)
    return _logits(params, x, cfg)


def llama_loss(params: Params, batch: dict, cfg: LlamaConfig
               ) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["targets"]`` (B, T); the padded vocab's logits are masked
    to -1e9, as in the JAX model."""
    logits = llama_forward(params, batch["tokens"], cfg)
    mask = replicate_like(torch.arange(cfg.padded_vocab,
                                       device=logits.device),
                          logits) < cfg.vocab_size
    logits = torch.where(mask, logits, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["targets"].long()[..., None]).mean()


def llama_prefill_chunk_kv(params: Params, tokens: torch.Tensor, start: int,
                           k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                           ctx_mask: torch.Tensor, chunk_mask: torch.Tensor,
                           cfg: LlamaConfig
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Chunked prefill from a position offset; see
    gpt2.gpt2_prefill_chunk_kv. k_ctx/v_ctx are (L, B, C, H_kv, D);
    returns (logits (B, T, Vp) f32, k, v (L, B, T, H_kv, D))."""
    rope = chunk_rope(start, tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                      tokens.device)

    def step(i, p, x):
        return _chunk_block(x, p, k_ctx[i], v_ctx[i], ctx_mask,
                            chunk_mask, rope, cfg)

    x, k, v = tree.scan_layers(params["blocks"], _embed(params, tokens, cfg),
                               step)
    return _logits(params, x, cfg), k, v


def llama_decode_kv(params: Params, tokens: torch.Tensor,
                    positions: torch.Tensor, k_ctx: torch.Tensor,
                    v_ctx: torch.Tensor, ctx_mask: torch.Tensor,
                    cfg: LlamaConfig
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense decode step; see gpt2.gpt2_decode_kv. k_ctx/v_ctx are
    (L, B, C, H_kv, D); returns (logits (B, Vp) f32, k_new, v_new
    (L, B, H_kv, D))."""
    rope = decode_rope(positions, cfg.head_dim, cfg.rope_theta)

    def step(i, p, x):
        return _decode_block(x, p, k_ctx[i], v_ctx[i], ctx_mask, rope, cfg)

    x, k, v = tree.scan_layers(params["blocks"], _embed(params, tokens, cfg),
                               step)
    return _logits(params, x, cfg), k, v


def llama_decode_paged_kv(params: Params, tokens: torch.Tensor,
                          positions: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          cfg: LlamaConfig
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One decode step against the page pool (L, num_blocks, block_size,
    H_kv, D) through kernel K4; see gpt2.gpt2_decode_paged_kv. Returns
    (logits (B, Vp) f32, k_new, v_new (L, B, H_kv, D))."""
    rope = decode_rope(positions, cfg.head_dim, cfg.rope_theta)

    def step(i, p, x):
        return _decode_block(x, p, None, None, None, rope, cfg,
                             attend=decode_hook(k_pages[i], v_pages[i],
                                                tables, positions))

    x, k, v = tree.scan_layers(params["blocks"], _embed(params, tokens, cfg),
                               step)
    return _logits(params, x, cfg), k, v


def llama_verify_paged_kv(params: Params, tokens: torch.Tensor, start: int,
                          k_pages: torch.Tensor, v_pages: torch.Tensor,
                          table: torch.Tensor, cfg: LlamaConfig
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Speculative verify window against the page pool through kernel K4;
    see gpt2.gpt2_verify_paged_kv. tokens (1, W) at positions
    start..start+W-1. Returns (logits (1, W, Vp) f32, k, v
    (L, 1, W, H_kv, D))."""
    dev = tokens.device
    # the JAX model rotates the window at start + arange(W) unclipped
    # (Llama has no position table); a padded row past max_model_len
    # rotates at its own position and lands in the null page
    rope = chunk_rope(start, tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                      dev)
    tables = table[None]
    ctx_len = torch.full((1,), start, dtype=torch.int32, device=dev)

    def step(i, p, x):
        return _chunk_block(x, p, None, None, None, None, rope, cfg,
                            attend=window_hook(k_pages[i], v_pages[i],
                                               tables, ctx_len))

    x, k, v = tree.scan_layers(params["blocks"], _embed(params, tokens, cfg),
                               step)
    return _logits(params, x, cfg), k, v

