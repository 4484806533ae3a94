"""Causal multi-head attention: the port of ``ray_tpu/ops/attention.py``.

- `causal_attention_reference`: the plain einsum formulation with the
  JAX module's semantics (f32 logits, mask -1e30, probabilities cast to
  q's dtype before the PV product).
- `causal_attention`: the model's entry point. It always goes through
  `flash_attention`, which launches kernel K1 on a CUDA tensor and runs
  its plain version on a CPU tensor, and is differentiable: its
  backward launches K2 and K3 on the card and runs their plain version
  on the CPU.
- `context_attention` and `context_decode_attention`: the serving
  paths' attention over a dense gathered context (chunked prefill,
  dense decode), the JAX models' plain einsum math, which runs outside
  any Pallas kernel there too. K/V with fewer heads than q (grouped
  queries) are repeated up to q's heads, query head h reading KV head
  h // (H / H_kv), as ``jnp.repeat`` does.

Deviation from the JAX module: it sends only T >= 512 to the flash
kernel (`_FLASH_MIN_SEQ`, a cost decision for the TPU) and uses the
einsum below that. Here every prefill length launches K1; with the cut,
GPT-2 serving would run the plain version for most prompts on the card.
There is also no try/except fallback: a CUDA tensor the kernel cannot
take raises.

On a mesh, `causal_attention` takes DTensor operands and runs the
kernels on each rank's local shard through DTensor's ``local_map``:
the batch dim keeps its shards (data/fsdp) and the head dim its own
(tensor), so K1, and K2/K3 through the flash operator's registered
backward, see (B / shards, T, H / shards, D); a sharded T or D, or a
pending sum, is redistributed first. Heads that arrive whole (GPT-2's
fused qkv projection leaves q, k and v whole after its split) are split
over the first mesh dim of size > 1 on which q is replicated and whose
size divides them, so no two ranks run the same heads. No sharding
strategy is registered for the operator itself. The serving paths'
attention over a cache (`context_attention`, `context_decode_attention`,
and the paged hooks of ``ops/paged_attention.py``) runs through
`on_local_heads`, where the cache's own layout decides: pages sharded
over a mesh axis on the KV-head dim shard every operand's heads over
it, and replicated pages (KV heads that do not divide) replicate every
operand, so each rank attends all heads and every query head reads the
KV head it maps to, ``h // (H / H_kv)``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.ops.flash_attention import flash_attention

def on_local_heads(fn, args, head_dims, kv, kv_dim: int, out_dim: int):
    """``fn(*args)`` on each rank's local heads, its one output a DTensor
    when any argument is one. `kv` (one of `args`, a DTensor) decides the
    layout: over each mesh dim where it is sharded on its head dim
    `kv_dim`, every DTensor argument is sharded on its own head dim
    (`head_dims`, one entry per argument) and so is the output on
    `out_dim`; over every other mesh dim all are replicated. Plain
    arguments (masks, tables, positions, the same on every rank) pass as
    they are."""
    if not isinstance(kv, DTensor):
        return fn(*args)
    mesh = kv.device_mesh
    split = {i for i, p in enumerate(kv.placements)
             if isinstance(p, Shard) and p.dim % kv.ndim == kv_dim}

    def pl(dim):
        return tuple(Shard(dim) if i in split else Replicate()
                     for i in range(mesh.ndim))

    in_pl = tuple(pl(d) if isinstance(a, DTensor) else None
                  for a, d in zip(args, head_dims))
    # one output: its placements as a list (a tuple means one per output)
    return local_map(fn, list(pl(out_dim)), in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, D) -> (B, T, H, D), causal."""
    T, D = q.shape[1], q.shape[3]
    scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(keep, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal attention through the flash kernels at every length: K1
    forward, K2 and K3 backward; on DTensors, on each rank's shard."""
    if isinstance(q, DTensor):
        return _local_causal_attention(q, k, v)
    return flash_attention(q, k, v, causal=True)


def _local_flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


def _local_causal_attention(q, k, v):
    """q, k, v DTensors (B, T, H, D): the layout of q with only its batch
    (dim 0) and head (dim 2) shards kept, whole heads split over the
    first replicated mesh dim they divide over, every operand
    redistributed to it, and the kernels run on the local shards."""
    ndim, H = q.ndim, q.shape[2]
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim % ndim in (0, 2)
          else Replicate() for p in q.placements]
    if not any(isinstance(p, Shard) and p.dim % ndim == 2 for p in pl):
        for i, p in enumerate(pl):
            if isinstance(p, Replicate) and mesh.size(i) > 1 \
                    and H % mesh.size(i) == 0:
                pl[i] = Shard(2)
                break
    pl = tuple(pl)
    # one output: its placements as a list (a tuple means one per output)
    return local_map(_local_flash, list(pl), in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _repeat_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    """t (..., H_kv, D) with each KV head repeated up to `heads`, in the
    order of ``jnp.repeat`` (never ``.repeat``, which tiles)."""
    rep = heads // t.shape[-2]
    return t if rep == 1 else t.repeat_interleave(rep, dim=-2)


def context_attention(q, k, v, k_ctx, v_ctx, ctx_mask, chunk_mask):
    """Attention of a chunk q (B, T, H, D) over the cached context
    k_ctx/v_ctx (B, C, H_kv, D), the slots where ctx_mask (B, C) is set,
    plus the chunk's own k/v (B, T, H_kv, D), causally among its real
    positions (chunk_mask (B, T)). f32 scores, mask -1e30, probabilities
    cast to q's dtype before the PV products. Returns (B, T, H, D); on
    DTensors, on each rank's heads (`on_local_heads`, the context's
    layout deciding)."""
    return on_local_heads(
        _context_attention, (q, k, v, k_ctx, v_ctx, ctx_mask, chunk_mask),
        (2, 2, 2, 2, 2, None, None), k_ctx, 2, 2)


def _context_attention(q, k, v, k_ctx, v_ctx, ctx_mask, chunk_mask):
    B, T, H, D = q.shape
    C = k_ctx.shape[1]
    k_ctx, v_ctx, k, v = (_repeat_kv(t, H) for t in (k_ctx, v_ctx, k, v))
    scale = 1.0 / (D ** 0.5)
    s_ctx = torch.einsum("bthd,bchd->bhtc", q, k_ctx).float()
    s_own = torch.einsum("bthd,bshd->bhts", q, k).float()
    s = torch.cat([s_ctx, s_own], dim=-1) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    valid = torch.cat([ctx_mask[:, None, :].expand(B, T, C),
                       causal[None] & chunk_mask[:, None, :]], dim=-1)
    s = torch.where(valid[:, None, :, :], s, -1e30)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhtc,bchd->bthd", probs[..., :C], v_ctx) \
        + torch.einsum("bhts,bshd->bthd", probs[..., C:], v)


def context_decode_attention(q, k, v, k_ctx, v_ctx, ctx_mask):
    """Attention of one token a sequence, q (B, H, D), over the cached
    context k_ctx/v_ctx (B, C, H_kv, D), the slots where ctx_mask (B, C)
    is set, plus its own k/v (B, H_kv, D). Returns (B, H, D); on
    DTensors, on each rank's heads, as `context_attention`."""
    return on_local_heads(
        _context_decode_attention, (q, k, v, k_ctx, v_ctx, ctx_mask),
        (1, 1, 1, 2, 2, None), k_ctx, 2, 1)


def _context_decode_attention(q, k, v, k_ctx, v_ctx, ctx_mask):
    B, H, D = q.shape
    k_ctx, v_ctx, k, v = (_repeat_kv(t, H) for t in (k_ctx, v_ctx, k, v))
    scale = 1.0 / (D ** 0.5)
    s_ctx = torch.einsum("bhd,bchd->bhc", q, k_ctx).float()
    s_own = (q * k).sum(dim=-1, dtype=torch.float32)
    s = torch.cat([s_ctx, s_own[:, :, None]], dim=-1) * scale
    valid = torch.cat([ctx_mask, torch.ones(B, 1, dtype=torch.bool,
                                            device=q.device)], dim=-1)
    s = torch.where(valid[:, None, :], s, -1e30)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhc,bchd->bhd", probs[..., :-1], v_ctx) \
        + probs[..., -1:] * v
