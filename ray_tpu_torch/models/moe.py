"""Mixture-of-Experts layer with expert parallelism: the port of
``ray_tpu/models/moe.py``.

- top-k softmax gating with capacity-based token dropping
  (Switch/GShard): dispatch and combine are one-hot einsums with static
  shapes and no sorting;
- the expert dim of the expert weights carries the ``expert`` mesh axis
  in `moe_partition_rules`; with the tokens sharded over the batch axes
  and the experts over ``expert``, DTensor's propagation places the
  collectives where GSPMD does in the JAX layer (`constrain` lays the
  dispatched tokens out over ``expert``);
- f32 gate statistics, ``cfg.dtype`` expert compute; the Switch
  load-balancing loss is returned beside the output.

Plain PyTorch, as the JAX layer is plain ``jnp`` with no Pallas kernel.

Deviations, none of which changes a value: ``jax.lax.top_k`` becomes
``torch.topk`` (the two may order equal probabilities differently; an
f32 tie between two experts' softmax outputs is not expected from
continuous inputs); ``jax.nn.one_hot`` becomes a comparison against
``arange``, which also gives an all-zero row for an index past the last
class (a token over capacity), where ``torch.nn.functional.one_hot``
would raise; ``jax.nn.gelu`` is the tanh form. `init_moe` draws from a
seeded ``torch.Generator`` with the JAX layer's shapes and scales, not
its bits: the tests carry JAX parameters across through ``interop``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.sharding import (
    PartitionSpec as P,
    constrain,
    replicate_like,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 128
    d_ff: int = 512
    dtype: torch.dtype = torch.bfloat16


def init_moe(generator: torch.Generator, cfg: MoEConfig,
             device: str | torch.device | None = None) -> dict:
    """Float32 params on `device` (None: "cuda"): the gate kernel
    normal(0.02), the expert kernels He-scaled, as the JAX layer."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_moe: the params go to the card by default, and no card "
            "is available; pass device='cpu' to make them on the CPU")
    E, Dm, Df = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(dev)

    return {
        "gate": {"kernel": normal((Dm, E), 0.02)},
        "wi": normal((E, Dm, Df), (2.0 / Dm) ** 0.5),  # expert-sharded
        "wo": normal((E, Df, Dm), (2.0 / Df) ** 0.5),
    }


def moe_partition_rules() -> list[tuple[str, P]]:
    """Merge into a model's PartitionRules: expert weights shard their
    leading (expert) dim on the `expert` axis, ff dim on `tensor`."""
    return [
        (r"moe/wi$", P("expert", "fsdp", "tensor")),
        (r"moe/wo$", P("expert", "tensor", "fsdp")),
        (r"moe/gate/kernel$", P(None, None)),
    ]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32: an index outside [0, n) gives
    a row of zeros."""
    classes = replicate_like(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == classes).float()


def moe_layer(params: dict, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, Dm) -> (out (B, T, Dm), aux_loss scalar)."""
    B, T, Dm = x.shape
    E = cfg.num_experts
    N = B * T
    cap = max(1, int(cfg.capacity_factor * N * cfg.top_k / E))
    xt = x.reshape(N, Dm)
    dt = cfg.dtype

    gate_logits = xt.float() @ params["gate"]["kernel"].float()  # (N, E)
    probs = torch.softmax(gate_logits, dim=-1)

    # top-k expert choice per token; the values are gathered at the
    # chosen indices (the same numbers and gradient as top_k's own),
    # since the backward of torch.topk on a DTensor builds a plain
    # tensor of zeros that DTensor refuses to scatter into
    gate_idx = torch.topk(probs.detach(), cfg.top_k, dim=-1).indices
    gate_vals = probs.gather(-1, gate_idx)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # capacity assignment: position of each token within its expert's
    # queue, computed per (k)-choice with a running cumsum (GShard-style)
    def zeros(*shape, dtype=torch.float32):
        return replicate_like(torch.zeros(shape, dtype=dtype,
                                          device=x.device), x)

    combine = zeros(N, E, cap)
    used = zeros(N, E)  # one-hot accumulation for aux
    position_in_expert = zeros(E, dtype=torch.int32)
    for choice in range(cfg.top_k):
        idx = gate_idx[:, choice]  # (N,)
        onehot = _one_hot(idx, E)  # (N, E)
        # rank of each token within this expert across the batch
        pos = (torch.cumsum(onehot, dim=0) - onehot) \
            + position_in_expert[None, :].float()
        position_in_expert = position_in_expert \
            + onehot.sum(dim=0).to(torch.int32)
        pos_tok = (pos * onehot).sum(dim=-1)  # (N,)
        keep = pos_tok < cap
        w = gate_vals[:, choice] * keep.float()
        pos_oh = _one_hot(pos_tok.to(torch.int32), cap)  # (N, cap)
        combine = combine + w[:, None, None] * onehot[:, :, None] \
            * pos_oh[:, None, :]
        used = used + onehot

    dispatch = (combine > 0.0).to(dt)  # (N, E, cap)

    # dispatch: (N,E,cap) x (N,Dm) -> (E,cap,Dm); sharded over `expert`
    xe = torch.einsum("nec,nd->ecd", dispatch, xt.to(dt))
    xe = constrain(xe, "expert", None, None)
    h = torch.einsum("ecd,edf->ecf", xe, params["wi"].to(dt))
    h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, params["wo"].to(dt))
    ye = constrain(ye, "expert", None, None)
    # combine back: weighted sum over experts/capacity slots
    out = torch.einsum("nec,ecd->nd", combine.to(dt), ye)

    # Switch-style load balancing aux loss: E * sum_e f_e * p_e
    frac_tokens = used.mean(dim=0) / cfg.top_k  # (E,)
    frac_probs = probs.mean(dim=0)
    aux = E * (frac_tokens * frac_probs).sum()
    return out.reshape(B, T, Dm).to(x.dtype), aux
