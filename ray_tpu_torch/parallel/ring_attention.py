"""Ring attention and Ulysses: causal attention over a sequence-sharded
mesh axis.

The port of ``ray_tpu/parallel/ring_attention.py``, for use inside the
port's `shard_map` over the ``seq`` axis (or any axis named):

- `ring_attention`: every rank holds a (B, T/n, H, D) shard of q/k/v; n
  ring steps attend the local q block against the k/v block it holds
  with an online-softmax update in f32 (running max from -inf, masked
  scores -1e30), then pass the k/v block one hop around the ring with
  `ppermute`, never holding more than a (T/n) x (T/n) score block. A
  k/v block wholly in the future contributes nothing; the diagonal block
  is masked triangularly. Plain PyTorch, as the JAX module is plain
  ``jnp`` with no Pallas kernel; differentiable through autograd and
  the permutation's transpose.
- `ulysses_attention`: the tiled `all_to_all` swaps the sharded dim
  from sequence to heads, `attn_fn` runs full-sequence attention on
  H/n heads a rank, and a second all-to-all swaps back. The default
  `attn_fn` is the plain ``causal_attention_reference``, as in JAX;
  pass ``ops.attention.causal_attention`` to run the flash kernels
  (K1 forward, K2 and K3 backward) on the card.

Deviation: ``lax.scan`` over the ring steps becomes a Python loop, and
the index of the block a rank holds (``src``) is a host int, as
``axis_index`` is here.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.ops import (
    all_to_all,
    axis_index as _axis_index,
    axis_size as _axis_size,
    ppermute,
)
from ray_tpu_torch.parallel.sharding import replicate_like

_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "seq", causal: bool = True
                   ) -> torch.Tensor:
    """q,k,v: per-rank (B, t, H, D) shards of a (B, T, H, D) global
    tensor sharded on dim 1 over `axis_name`. Returns the matching output
    shard. Call inside shard_map over that axis."""
    B, t, H, D = q.shape
    n = _axis_size(axis_name)
    my = _axis_index(axis_name)
    scale = 1.0 / (D ** 0.5)
    qf = q.float()

    dev = q.device

    def const(x):
        # on q's mesh when q is a DTensor (inside a shard_map that leaves
        # other axes automatic): the same on every rank
        return replicate_like(x, q)

    # positions of the local q rows within the GLOBAL sequence
    q_pos = const(my * t + torch.arange(t, device=dev))  # (t,)
    perm = [(i, (i + 1) % n) for i in range(n)]

    o = const(torch.zeros((B, t, H, D), device=dev))
    m = const(torch.full((B, H, t), -torch.inf, device=dev))
    l = const(torch.zeros((B, H, t), device=dev))
    kb, vb, src = k, v, my
    for _ in range(n):
        # which global block the held kv is: src
        kv_pos = const(src * t + torch.arange(t, device=dev))  # (t,)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]  # (t_q, t_k)
            s = torch.where(mask[None, None], s, _NEG)
        m_blk = s.amax(dim=-1)  # (B,H,t)
        m_new = torch.maximum(m, m_blk)
        p = torch.exp(s - m_new[..., None])  # (B,H,t,t)
        alpha = torch.exp(m - m_new)  # (B,H,t)
        l_new = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m, l = m_new, l_new
        kb = ppermute(kb, axis_name, perm)
        vb = ppermute(vb, axis_name, perm)
        src = (src - 1) % n  # after the shift we hold our neighbor's block
    # fully-masked rows (none in causal)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = o / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "seq", causal: bool = True,
                      attn_fn=None) -> torch.Tensor:
    """Ulysses-style sequence parallelism: all-to-all swaps the sharded
    dimension from sequence to heads, runs FULL-sequence attention on
    H/n heads per rank, and swaps back. Cheaper than a ring when
    H >= n and the full T fits on a rank.

    q,k,v: per-rank (B, T/n, H, D) shards -> same-shaped output shard.
    `attn_fn(q,k,v)` runs the dense attention (defaults to the causal
    einsum reference; pass ``ops.attention.causal_attention`` for the
    flash kernels). `causal` is unused, as in the JAX function: the
    attention is whatever `attn_fn` computes."""
    if attn_fn is None:
        from ray_tpu_torch.ops.attention import causal_attention_reference

        attn_fn = causal_attention_reference

    def a2a(x, split, concat):
        return all_to_all(x, axis_name, split_axis=split,
                          concat_axis=concat)

    # (B, T/n, H, D) -> (B, T, H/n, D)
    qh, kh, vh = (a2a(x, 2, 1) for x in (q, k, v))
    oh = attn_fn(qh, kh, vh)
    # back: (B, T, H/n, D) -> (B, T/n, H, D)
    return a2a(oh, 1, 2)
