"""Pipelined transformer: the port of ``ray_tpu/models/pipelined.py``.

A multi-stage model on a dcn x data x pipe x fsdp x tensor mesh:

- the transformer BLOCKS are stacked on a leading virtual-stage dim and
  sharded over ``pipe``; the interleaved circular schedule
  (``parallel/pipeline.py`` `pipeline_apply_interleaved`) runs them
  with an (S-1)/(R*M) bubble;
- attention inside every block is RING ATTENTION over the ``fsdp``
  axis: the sequence dim is context-parallel across the fsdp group;
- embed/head and the loss live OUTSIDE the manual region: the port's
  ``shard_map(axis_names={"pipe", "fsdp"})`` leaves the other mesh axes
  (dcn, data, tensor) automatic, so inside the blocks the batch stays a
  DTensor sharded over them and the block weights over ``tensor``,
  with DTensor's propagation inserting the collectives as GSPMD does.

Plain PyTorch: the JAX model runs no Pallas kernel either (its
attention is the ring's einsums). Params are float32; `init_pipelined`
draws them from a seeded ``torch.Generator`` with the JAX model's
shapes and scales (the tests carry JAX params across through
``interop``). On a mesh they are DTensors laid out by
`pipelined_shardings`; a plain tensor given with a mesh is taken as
the global value, the same on every rank.

Deviations: ``jax.lax.scan`` over a stage's blocks becomes a loop;
`stage_apply` without a mesh runs under a one-device ``fsdp`` mesh
(`_local_mesh`, an ``AbstractMesh``, over which the ring is one step),
since a ``DeviceMesh`` of one rank needs a process group of its own.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch.parallel.mesh import AbstractMesh, mesh_shape
from ray_tpu_torch.parallel.ops import shard_map
from ray_tpu_torch.parallel.pipeline import pipeline_apply_interleaved
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec as P,
    _prune_spec,
    replicate_like,
    use_mesh,
)
from ray_tpu_torch.util import tree


@dataclasses.dataclass(frozen=True)
class PipelinedConfig:
    vocab_size: int = 256
    n_virtual_stages: int = 4  # total blocks = virtual stages
    n_head: int = 4
    d_model: int = 64
    d_ff: int = 128
    block_size: int = 32
    num_microbatches: int = 4


def init_pipelined(generator: torch.Generator, cfg: PipelinedConfig,
                   device: str | torch.device | None = None) -> dict:
    """Stacked-block params on `device` (None: "cuda"): every block
    tensor has a leading (n_virtual_stages,) dim the caller shards over
    `pipe`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_pipelined: the params go to the card by default, and no "
            "card is available; pass device='cpu' to make them on the CPU")
    V, D, Fd = cfg.n_virtual_stages, cfg.d_model, cfg.d_ff

    def n(shape, scale=0.02):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(dev)

    return {
        "embed": n((cfg.vocab_size, D)),
        "pos": n((cfg.block_size, D)),
        "blocks": {
            "qkv": n((V, D, 3 * D)),
            "attn_out": n((V, D, D)),
            "fc": n((V, D, Fd)),
            "proj": n((V, Fd, D)),
        },
        "ln_f": torch.ones(D, device=dev),
        "head": n((D, cfg.vocab_size)),
    }


def _rms(x):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)


def _block(cfg: PipelinedConfig, params, h):
    """One transformer block; h is the LOCAL (mb, t, D) shard with the
    sequence dim context-parallel over `fsdp` (ring attention)."""
    mb, t, D = h.shape
    H = cfg.n_head
    qkv = _rms(h) @ params["qkv"]  # (mb, t, 3D)
    q, k, v = (a.reshape(mb, t, H, D // H) for a in qkv.split(D, dim=-1))
    att = ring_attention(q, k, v, "fsdp", causal=True)
    h = h + att.reshape(mb, t, D) @ params["attn_out"]
    h = h + F.gelu(_rms(h) @ params["fc"], approximate="tanh") \
        @ params["proj"]
    return h


def _spec(mesh, *entries) -> P:
    return _prune_spec(P(*entries), mesh)


def _head_loss(params, h, targets):
    """Final norm, head and the mean next-token NLL (logits when
    `targets` is None)."""
    logits = _rms(h * replicate_like(params["ln_f"], h)) \
        @ replicate_like(params["head"], h)
    if targets is None:
        return logits
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, replicate_like(targets, logp).long()[..., None])
    loss = nll.mean()
    if isinstance(loss, DTensor):
        # reduce a pending mean now: a scalar with a pending average is
        # not one autograd can start a backward from
        loss = loss.redistribute(loss.device_mesh,
                                 [Replicate()] * loss.device_mesh.ndim)
    return loss


def pipelined_loss(params, batch, cfg: PipelinedConfig, mesh,
                   num_repeats: int | None = None):
    """Full forward + next-token loss. Blocks run under
    shard_map(axis_names={pipe, fsdp}); everything else is automatic."""
    pipe = mesh_shape(mesh).get("pipe", 1)
    R = num_repeats or max(1, cfg.n_virtual_stages // pipe)
    tokens, targets = batch["tokens"], batch["targets"]
    tokens = replicate_like(tokens, params["embed"]).long()
    h = params["embed"][tokens] + params["pos"][None, :tokens.shape[1]]

    # round-robin virtual-stage placement: stage v -> (rank v % S, slot
    # v // S); reorder the stacked dim so shard_map's contiguous split
    # hands rank s exactly its slots in order
    S = pipe
    order = np.argsort(np.arange(cfg.n_virtual_stages) % S, kind="stable")
    names = sorted(params["blocks"])
    blocks = [params["blocks"][k] for k in names]
    blocks = [p[replicate_like(torch.as_tensor(order, device=p.device), p)]
              for p in blocks]

    def body(hh, *leaves):
        # hh: (B, t_local, D) — batch automatic (dcn/data), sequence
        # manually sharded over fsdp; leaves: this pipe rank's (R, ...)
        # virtual stages
        return pipeline_apply_interleaved(
            partial(_block, cfg), dict(zip(names, leaves)), hh, "pipe",
            num_microbatches=cfg.num_microbatches, num_repeats=R)

    seq = _spec(mesh, None, "fsdp", None)
    h = shard_map(body, mesh,
                  in_specs=(seq,) + (_spec(mesh, "pipe"),) * len(blocks),
                  out_specs=seq, axis_names={"pipe", "fsdp"})(h, *blocks)
    return _head_loss(params, h, targets)


# ---------------------------------------------------------------------------
# MPMD stage split — the 1F1B worker-group strategy's model face
# ---------------------------------------------------------------------------


def split_pipeline_stages(params, cfg: PipelinedConfig,
                          num_stages: int) -> list[dict]:
    """Split a full pipelined-param tree into `num_stages` contiguous
    stage subtrees for the MPMD strategy: stage s gets
    blocks[V*s//S : V*(s+1)//S]; stage 0 additionally owns embed/pos,
    the last stage ln_f/head. Union of stages == the full tree, so a
    single-program run of the same params is the parity reference."""
    V, S = cfg.n_virtual_stages, num_stages
    if not 1 <= S <= V:
        raise ValueError(f"need 1 <= stages <= {V} blocks, got {S}")
    stages = []
    for s in range(S):
        lo, hi = V * s // S, V * (s + 1) // S
        stage = {"blocks": tree.tree_map(lambda p: p[lo:hi],
                                         params["blocks"])}
        if s == 0:
            stage["embed"], stage["pos"] = params["embed"], params["pos"]
        if s == S - 1:
            stage["ln_f"], stage["head"] = params["ln_f"], params["head"]
        stages.append(stage)
    return stages


def merge_pipeline_stages(stages: list[dict]) -> dict:
    """Inverse of `split_pipeline_stages` (checkpointing / parity)."""
    names = stages[0]["blocks"]
    blocks = {k: torch.cat([st["blocks"][k] for st in stages], dim=0)
              for k in names}
    return {"embed": stages[0]["embed"], "pos": stages[0]["pos"],
            "blocks": blocks, "ln_f": stages[-1]["ln_f"],
            "head": stages[-1]["head"]}


def split_pipeline_stages_interleaved(params, cfg: PipelinedConfig,
                                      num_stages: int, num_repeats: int
                                      ) -> list[list[dict]]:
    """Round-robin virtual-stage split for the interleaved MPMD
    strategy: the model becomes V = S*R virtual chunks (contiguous
    block runs, split exactly like `split_pipeline_stages(.., V)`), and
    worker s owns chunks [s, s+S, .., s+(R-1)S] — result[s][r] is
    virtual stage r*S + s. Chunk 0 carries embed/pos, chunk V-1 carries
    ln_f/head, so each chunk is directly usable with `stage_apply(..,
    stage_idx=v, num_stages=V, ..)`."""
    V = num_stages * num_repeats
    chunks = split_pipeline_stages(params, cfg, V)
    return [[chunks[r * num_stages + s] for r in range(num_repeats)]
            for s in range(num_stages)]


def merge_pipeline_stages_interleaved(stage_chunks: list[list[dict]]
                                      ) -> dict:
    """Inverse of `split_pipeline_stages_interleaved`: reassemble the
    full tree from per-worker chunk lists (checkpointing / parity)."""
    S, R = len(stage_chunks), len(stage_chunks[0])
    flat = [stage_chunks[v % S][v // S] for v in range(S * R)]
    return merge_pipeline_stages(flat)


def _local_mesh() -> AbstractMesh:
    """A one-device mesh carrying the `fsdp` axis, so `_block`'s ring
    attention resolves outside the hybrid-mesh program (a size-1 ring
    is plain causal attention, the same blockwise softmax)."""
    return AbstractMesh({"fsdp": 1})


def stage_apply(cfg: PipelinedConfig, stage_params: dict, stage_idx: int,
                num_stages: int, payload, targets=None, mesh=None):
    """One pipeline stage's forward: tokens -> h for stage 0, h -> h in
    the middle, h -> scalar loss (or logits when `targets` is None) on
    the last stage. Runs the SAME `_block` math as `pipelined_loss`, so
    chaining all stages reproduces the single-program loss up to float
    reassociation. Differentiable. A `mesh` carrying a `data` axis (an
    intra-stage data-parallel group) splits the microbatch over it;
    block weights stay replicated."""
    first, last = stage_idx == 0, stage_idx == num_stages - 1
    if first:
        tokens = payload.long()
        h = stage_params["embed"][tokens] \
            + stage_params["pos"][None, :tokens.shape[1]]
    else:
        h = payload
    names = sorted(stage_params["blocks"])

    def body(hh, *leaves):
        for blk in tree.unstack(dict(zip(names, leaves))):
            hh = _block(cfg, blk, hh)
        return hh

    leaves = [stage_params["blocks"][k] for k in names]
    if mesh is None:
        with use_mesh(_local_mesh()):
            h = body(h, *leaves)
    else:
        bspec = _spec(mesh, "data")
        h = shard_map(body, mesh, in_specs=(bspec,) + (P(),) * len(leaves),
                      out_specs=bspec)(h, *leaves)
    if not last:
        return h
    return _head_loss(stage_params, h, targets)


def pipelined_shardings(params, cfg: PipelinedConfig, mesh):
    """NamedShardings (their ``placements`` lay a leaf out with
    ``distribute_tensor``): block stacks over pipe (+ tensor on the wide
    dim), embed/head over tensor, rest replicated."""
    def spec(path):
        name = path[-1] if path else ""
        if name in ("qkv", "fc"):
            return P("pipe", None, "tensor")
        if name in ("attn_out", "proj"):
            return P("pipe", "tensor", None)
        if name in ("embed", "head"):
            return P(None, "tensor")
        return P()

    return tree.tree_map_with_path(
        lambda path, _: NamedSharding(mesh, _prune_spec(spec(path), mesh)),
        params)


def pipelined_train_step(cfg: PipelinedConfig, mesh, lr: float = 1e-2):
    """(params, batch) -> (params, loss): one SGD step over the hybrid
    mesh."""

    def step(params, batch):
        live = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
        loss = pipelined_loss(live, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, tree.leaves(live))
        new = [p.detach() - lr * g for p, g in zip(tree.leaves(live), grads)]
        return tree.unflatten(params, new), loss.detach()

    return step
