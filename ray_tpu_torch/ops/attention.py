"""Causal multi-head attention: the port of ``ray_tpu/ops/attention.py``.

- `causal_attention_reference`: the plain einsum formulation with the
  JAX module's semantics (f32 logits, mask -1e30, probabilities cast to
  q's dtype before the PV product).
- `causal_attention`: the model's entry point. It always goes through
  `flash_attention`, which launches kernel K1 on a CUDA tensor and runs
  its plain version on a CPU tensor, and is differentiable: its
  backward launches K2 and K3 on the card and runs their plain version
  on the CPU.

Deviation from the JAX module: it sends only T >= 512 to the flash
kernel (`_FLASH_MIN_SEQ`, a cost decision for the TPU) and uses the
einsum below that. Here every prefill length launches K1; with the cut,
GPT-2 serving would run the plain version for most prompts on the card.
There is also no try/except fallback: a CUDA tensor the kernel cannot
take raises.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention


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
    forward, K2 and K3 backward."""
    return flash_attention(q, k, v, causal=True)
