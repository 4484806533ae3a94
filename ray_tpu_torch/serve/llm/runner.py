"""ModelRunner: prefill, chunked prefill, decode and speculative verify
steps on one device.

The port of ``ray_tpu/serve/llm/runner.py``. It owns the device half of
the KV cache, one K and one V tensor of shape
``(L, num_blocks, block_size, H_kv, D)`` in the JAX layout, and the
steps that touch it:

- **prefill**: full-sequence forward of one prompt, padded to a length
  bucket, through kernel K1; every position's K/V is scattered into its
  page and the first generated token is sampled from the last valid
  position's logits;
- **prefill_chunk**: a chunk of one prompt from a page-aligned offset,
  its context gathered through the block table and attended with the
  model's plain math (prefix-cache hits and long prompts);
- **decode**: one token for a batch of sequences, padded to a batch
  bucket: with paged attention through kernel K4, which reads the
  pages in place through each lane's block table; otherwise (the JAX
  default) over each lane's context gathered into a dense
  (L, S, C, H_kv, D) tensor with the plain math. The new K/V is
  scattered at the lane's position after the step;
- **verify**: one sequence's speculative window of W = K+1 tokens
  scored in one step (through K4 on the paged path, the chunk math
  otherwise), the acceptance rule applied on the device and one copy
  of its result to the host.

PyTorch runs eagerly, so the JAX runner's compiled-program bookkeeping
becomes plain shape padding: prompt and chunk lengths still round up to
powers of two from ``prefill_bucket_min``, decode batches to powers of
two up to ``max_batch_size``, and the verify window is always K+1 wide,
which keeps the kernels' shapes to a small set. Padded lanes and
positions point at page 0, the pool's null sink, so every scatter is in
bounds and the attention masks keep its contents out of the softmax.
The pages are updated in place (the JAX runner replaces them
functionally each step).

With a mesh, as in the JAX runner, the params are laid out by the
model's partition rules (`shard_pytree`) and the pages are sharded over
the ``tensor`` axis on the KV-head dim when the KV heads divide evenly,
else replicated; the pool's sizing follows the same rule
(``cache.auto_num_blocks(tensor_ways=)``). GSPMD places every
collective in JAX; here DTensor's propagation does for the projections
and the MLP, while every operation on the pages runs on each rank's
local heads: the scatter and the gather on the local page tensors, the
dense context attention and K4 through ``ops.attention.on_local_heads``,
and K1 through ``causal_attention``, which also splits the whole heads
GPT-2's fused projection leaves. Replicated pages replicate the
attention: each rank attends every head, so each query head reads the
KV head it maps to. The logits are made whole before sampling.

Deviation: JAX is one controller over the mesh; the port is one process
a rank, and every rank runs the same engine on the same requests. They
take the same scheduler decisions and draw the same tokens because the
whole logits are the same on every rank and each rank samples from the
same seeded ``torch.Generator``; the tests hold every rank's streams
equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ray_tpu_torch.ops import flash_attention, paged_attention
from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.parallel.sharding import shard_pytree


@dataclasses.dataclass(frozen=True)
class ModelAdapter:
    """Uniform view over a model family for the engine/runner."""

    name: str
    presets: dict[str, Callable[[], Any]]
    init_fn: Callable  # (generator, cfg, device=) -> params (f32 masters)
    serving_params_fn: Callable  # (params, cfg) -> compute-dtype copies
    prefill_fn: Callable  # (params, tokens, cfg) -> (logits, k, v)
    decode_fn: Callable  # (params, toks, pos, kc, vc, mask, cfg) -> ...
    # (params, toks, start, kc, vc, ctx_mask, chunk_mask, cfg) -> ...
    chunk_fn: Callable
    kv_heads: Callable[[Any], int]
    # paged-attention entry points (kernel K4 in the attention core
    # instead of a dense gathered context)
    # (params, toks, pos, k_pages, v_pages, tables, cfg) -> ...
    decode_paged_fn: Callable
    # (params, toks, start, k_pages, v_pages, table, cfg) -> ...
    verify_paged_fn: Callable
    rules_fn: Callable  # () -> PartitionRules, the layout on a mesh


def adapters() -> dict[str, ModelAdapter]:
    """Model registry (lazy imports keep `import ray_tpu_torch.serve`
    light)."""
    from ray_tpu_torch.models import gpt2, llama

    return {
        "gpt2": ModelAdapter(
            name="gpt2",
            presets={
                "tiny": gpt2.GPT2Config.tiny,
                "small": gpt2.GPT2Config.small,
                "medium": gpt2.GPT2Config.medium,
                "large": gpt2.GPT2Config.large,
                "xl": gpt2.GPT2Config.xl,
            },
            init_fn=gpt2.init_gpt2,
            serving_params_fn=gpt2.serving_params,
            prefill_fn=gpt2.gpt2_prefill_kv,
            decode_fn=gpt2.gpt2_decode_kv,
            chunk_fn=gpt2.gpt2_prefill_chunk_kv,
            kv_heads=lambda cfg: cfg.n_head,
            decode_paged_fn=gpt2.gpt2_decode_paged_kv,
            verify_paged_fn=gpt2.gpt2_verify_paged_kv,
            rules_fn=gpt2.gpt2_partition_rules,
        ),
        "llama": ModelAdapter(
            name="llama",
            presets={
                "tiny": llama.LlamaConfig.tiny,
                "small": llama.LlamaConfig.small,
            },
            init_fn=llama.init_llama,
            serving_params_fn=llama.serving_params,
            prefill_fn=llama.llama_prefill_kv,
            decode_fn=llama.llama_decode_kv,
            chunk_fn=llama.llama_prefill_chunk_kv,
            kv_heads=lambda cfg: cfg.n_kv_head,
            decode_paged_fn=llama.llama_decode_paged_kv,
            verify_paged_fn=llama.llama_verify_paged_kv,
            rules_fn=llama.llama_partition_rules,
        ),
    }


class DecodeItem(NamedTuple):
    token: int  # last sampled token (input to this step)
    pos: int  # its absolute position (== tokens written so far)
    table: Sequence[int]  # physical page ids, logical order
    temperature: float
    top_k: int = 0  # 0: disabled
    top_p: float = 1.0  # 1.0: disabled


def _next_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def logprob_at(logits, token: int, temperature: float,
               vocab_size: int) -> float:
    """Log-prob of `token` under the distribution it was sampled from:
    log-softmax over the real vocab (padding masked) of `logits`
    (one position's row), scaled by temperature when temperature > 0
    (greedy reports the unscaled policy log-prob). Host-side float64.

    This is THE logprob definition of the RL determinism contract
    (RL.md): the engine records rollout logprobs with it and the GRPO
    learner's teacher-forced reference recomputes them with it — one
    implementation, so the two cannot drift."""
    x = np.asarray(logits, np.float64)[:vocab_size]
    if temperature > 0:
        x = x / temperature
    x = x - x.max()
    return float(x[int(token)] - np.log(np.exp(x).sum()))


def truncation_cut(logits: torch.Tensor, safe: torch.Tensor,
                   topks: torch.Tensor, topps: torch.Tensor
                   ) -> torch.Tensor:
    """(S, 1) cutoff of the top-k / top-p filters (the JAX runner's
    `trunc_cut`): logits below it are dropped. One descending sort pays
    for both; topks 0 and topps 1.0 disable their filter. Top-p keeps
    the smallest prefix of descending probabilities, at temperature
    `safe`, whose mass reaches top_p (the item crossing it stays)."""
    V = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = (torch.where(topks > 0, topks, V) - 1).clamp(0, V - 1)
    kth = desc.gather(-1, k_idx.long()[:, None])
    p_desc = torch.softmax(desc / safe[:, None], dim=-1)
    keep = (torch.cumsum(p_desc, dim=-1) - p_desc) < topps[:, None]
    pth = torch.where(keep, desc, torch.inf).min(
        dim=-1, keepdim=True).values
    return torch.maximum(kth, pth)


def kernel_limit(cfg: Any, kv_heads: int, *, block_size: int,
                 max_blocks_per_seq: int, spec_width: int,
                 use_paged_attention: bool) -> str | None:
    """The first limit of the kernels an engine of this shape would
    launch on the card that it breaks, in words, or None: K1 for every
    monolithic prefill (the head dim, the dtype), and with paged
    attention K4 at W=1 (decode) and W=spec_width (the speculative
    verify window), over `block_size`-token pages."""
    limit = flash_attention.kernel_limit(cfg.head_dim, cfg.dtype)
    if limit is not None:
        return f"prefill through the flash kernel (K1): {limit}"
    if not use_paged_attention:
        return None
    for width in sorted({1, spec_width or 1}):
        limit = paged_attention.kernel_limit(
            block_size, cfg.head_dim, width, cfg.n_head // kv_heads,
            cfg.dtype, max_blocks_per_seq)
        if limit is not None:
            what = "decode" if width == 1 else "speculative verify"
            return f"{what} through the paged kernel (K4): {limit}"
    return None


class ModelRunner:
    """Executes prefill/decode/verify for one model instance on one
    device. Not thread-safe: exactly one step-loop thread drives it (the
    engine enforces this); construction may happen on another thread."""

    def __init__(
        self,
        adapter: ModelAdapter,
        cfg: Any,
        params: Any,
        *,
        block_size: int,
        num_blocks: int,
        max_model_len: int,
        max_batch_size: int,
        device: torch.device,
        prefill_bucket_min: int = 16,
        prefill_chunk_size: int | None = None,
        mesh=None,
        sample_seed: int = 0,
        num_draft_tokens: int = 0,
        use_paged_attention: bool = False,
    ):
        self.adapter = adapter
        self.cfg = cfg
        self.device = torch.device(device)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_model_len = max_model_len
        self.max_batch_size = max_batch_size
        self.prefill_bucket_min = prefill_bucket_min
        # chunked prefill: offsets and chunks stay page-aligned, so the
        # chunk size rounds up to a block multiple (and never exceeds
        # max_model_len). None disables chunking (monolithic prefill).
        if prefill_chunk_size is not None:
            c = max(block_size, prefill_chunk_size)
            c = ((c + block_size - 1) // block_size) * block_size
            prefill_chunk_size = min(c, max_model_len)
        self.prefill_chunk_size = prefill_chunk_size
        self.max_blocks_per_seq = (
            max_model_len + block_size - 1) // block_size
        # speculative verify: ONE step of fixed width K+1 (row 0 the last
        # committed token, rows 1..K the drafts) serves every outcome
        self.num_draft_tokens = num_draft_tokens
        self.spec_width = num_draft_tokens + 1 if num_draft_tokens else 0
        self.use_paged_attention = bool(use_paged_attention)
        self.mesh = mesh
        if mesh is not None:
            # `_on_mesh` replicates a one-element input (a one-lane
            # decode) as it does any other, which DTensor warns about
            warnings.filterwarnings(
                "ignore", message="Found a non-scalar tensor with numel=1")
        hk = adapter.kv_heads(cfg)
        tensor_ways = mesh_shape(mesh).get("tensor", 1) if mesh else 1
        # the JAX rule: pages shard over `tensor` on the KV-head dim when
        # the KV heads divide evenly, otherwise they are replicated
        self._shard_heads = tensor_ways > 1 and hk % tensor_ways == 0
        ways = tensor_ways if self._shard_heads else 1
        if self.device.type == "cuda":
            # a shape the kernels refuse fails here, not at the first step
            # that launches them; the CPU's plain versions take any shape
            # (on a mesh too: an even head split keeps K4's group)
            limit = kernel_limit(
                cfg, hk, block_size=block_size,
                max_blocks_per_seq=self.max_blocks_per_seq,
                spec_width=self.spec_width,
                use_paged_attention=self.use_paged_attention)
            if limit is not None:
                raise ValueError(f"{adapter.name}: the engine cannot run on "
                                 f"{self.device}: {limit}")
        local = (cfg.n_layer, num_blocks, block_size, hk // ways,
                 cfg.head_dim)
        self.k_pages, self.v_pages = (self._pages(local) for _ in "kv")
        self._lock = threading.Lock()
        self._install(params)
        # torch's generator cannot reproduce jax.random.categorical;
        # greedy lanes never draw from it
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(sample_seed)
        self._vocab_ok = torch.arange(
            cfg.padded_vocab, device=self.device) < cfg.vocab_size

    def _pages(self, local_shape) -> torch.Tensor:
        """A zeroed page tensor; on a mesh, a DTensor whose local part on
        each rank is `local_shape` (its KV heads, or all of them)."""
        t = torch.zeros(local_shape, dtype=self.cfg.dtype,
                        device=self.device)
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh, self._placements(3),
                                  run_check=False)

    def _placements(self, head_dim: int) -> tuple:
        """The pages' layout for a tensor with its KV heads on
        `head_dim`: sharded over `tensor` there, or replicated."""
        return tuple(
            Shard(head_dim) if self._shard_heads and name == "tensor"
            else Replicate() for name in self.mesh.mesh_dim_names)

    def _on_mesh(self):
        """The context every model call of a step runs in: on a mesh,
        plain step inputs (tokens, positions, masks, tables, the same on
        every rank) count as replicated. No step takes a gradient, so a
        plain tensor never meets a DTensor in a backward."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return implicit_replication()

    @staticmethod
    def _whole(t: torch.Tensor) -> torch.Tensor:
        """A DTensor gathered whole on every rank (the logits before
        sampling); a plain tensor as it is."""
        return t.full_tensor() if isinstance(t, DTensor) else t

    def _install(self, params: Any) -> None:
        """Keep the f32 masters and their compute-dtype copies (made
        once; bit-equal to casting at every call). On a mesh both are
        laid out by the model's partition rules."""
        if self.mesh is not None:
            params = shard_pytree(params, self.adapter.rules_fn(),
                                  self.mesh)
        compute = self.adapter.serving_params_fn(params, self.cfg)
        with self._lock:
            self.params = params
            self._compute = compute

    # ----------------------------------------------------------- sampling

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topks: np.ndarray, topps: np.ndarray) -> torch.Tensor:
        """Greedy when temp==0, else temperature sampling with optional
        top-k / top-p truncation; vocab padding is always masked out.
        The branches are taken on the host arrays, so a greedy batch
        runs no sort and draws nothing."""
        logits = torch.where(self._vocab_ok, logits, -1e30)
        greedy = logits.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy
        dev = self.device
        t = torch.as_tensor(temps, device=dev)
        safe = torch.where(t > 0, t, 1.0)
        if ((topks > 0) | (topps < 1.0)).any():
            cut = truncation_cut(logits, safe,
                                 torch.as_tensor(topks, device=dev),
                                 torch.as_tensor(topps, device=dev))
            logits = torch.where(logits < cut, -torch.inf, logits)
        probs = torch.softmax(logits / safe[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t > 0, sampled, greedy)

    # ---------------------------------------------------------- buckets

    def prefill_bucket(self, n: int) -> int:
        if n > self.max_model_len:
            raise ValueError(
                f"prompt of {n} tokens exceeds max_model_len "
                f"{self.max_model_len}")
        return min(_next_pow2(n, self.prefill_bucket_min),
                   self.max_model_len)

    def decode_bucket(self, n: int) -> int:
        return min(_next_pow2(n, 1), self.max_batch_size)

    def chunk_bucket(self, n: int) -> int:
        cap = self.prefill_chunk_size or self.max_model_len
        if n > cap:
            raise ValueError(f"chunk of {n} tokens exceeds chunk size {cap}")
        return min(_next_pow2(n, self.prefill_bucket_min), cap)

    # ------------------------------------------------------------- steps

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _local(self, pages: torch.Tensor) -> torch.Tensor:
        return pages.to_local() if self.mesh is not None else pages

    def _gather(self, tables: np.ndarray) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
        """The cached context of each table row (S, max_blocks_per_seq),
        gathered dense: k, v (L, S, C, H_kv, D), C = max_model_len
        rounded up to whole pages; on a mesh, each rank gathers its own
        KV heads into a DTensor laid out as the pages."""
        S, maxb = tables.shape
        idx = self._tensor(tables.astype(np.int64))
        out = []
        for pages in (self.k_pages, self.v_pages):
            local = self._local(pages)
            L, _, bs, hk, d = local.shape
            ctx = local[:, idx].reshape(L, S, maxb * bs, hk, d)
            if self.mesh is not None:
                ctx = DTensor.from_local(ctx, self.mesh,
                                         self._placements(3),
                                         run_check=False)
            out.append(ctx)
        return tuple(out)

    def _scatter(self, k: torch.Tensor, v: torch.Tensor,
                 block_ids: np.ndarray, offsets: np.ndarray) -> None:
        """Write k, v (L, N, H_kv, D) into the pages at (block, offset);
        on a mesh, each rank writes its own KV heads into its local
        pages."""
        bid = self._tensor(block_ids.astype(np.int64))
        off = self._tensor(offsets.astype(np.int64))
        for pages, new in ((self.k_pages, k), (self.v_pages, v)):
            if isinstance(new, DTensor):
                new = new.redistribute(self.mesh,
                                       self._placements(2)).to_local()
            self._local(pages)[:, bid, off] = new

    @torch.no_grad()
    def prefill(self, token_ids: Sequence[int], table: Sequence[int],
                temperature: float, top_k: int = 0, top_p: float = 1.0
                ) -> tuple[int, np.ndarray]:
        """Run one prompt through monolithic prefill; returns (first
        generated token, last-position logits). `table` must cover
        blocks_for_tokens(len(token_ids)) pages."""
        n = len(token_ids)
        Tb = self.prefill_bucket(n)
        toks = np.zeros((1, Tb), np.int64)
        toks[0, :n] = token_ids
        # padded positions scatter into the null page 0
        block_ids = np.zeros((Tb,), np.int64)
        offsets = np.arange(Tb, dtype=np.int64) % self.block_size
        pos = np.arange(n)
        block_ids[:n] = np.asarray(table, np.int64)[pos // self.block_size]
        with self._lock, self._on_mesh():
            logits, k, v = self.adapter.prefill_fn(
                self._compute, self._tensor(toks), self.cfg)
            self._scatter(k[:, 0], v[:, 0], block_ids, offsets)
            return self._first_token(self._whole(logits[0, n - 1]),
                                     temperature, top_k, top_p)

    def _first_token(self, last: torch.Tensor, temperature: float,
                     top_k: int, top_p: float) -> tuple[int, np.ndarray]:
        nxt = self._sample(last[None, :],
                           np.asarray([temperature], np.float32),
                           np.asarray([top_k], np.int32),
                           np.asarray([top_p], np.float32))
        return int(nxt[0]), last.cpu().numpy()

    @torch.no_grad()
    def prefill_chunk(self, token_ids: Sequence[int], start: int,
                      table: Sequence[int], temperature: float,
                      top_k: int = 0, top_p: float = 1.0
                      ) -> tuple[int, np.ndarray]:
        """Prefill-from-offset: run `token_ids` (<= prefill_chunk_size)
        at absolute positions start..start+n-1 against the cached
        context in `table`, which must already hold valid KV for every
        position < start and own the pages the chunk writes. `start`
        must be page-aligned. Returns (sampled next token, last chunk
        position's logits); the caller uses them on the final chunk
        only."""
        n = len(token_ids)
        if start % self.block_size:
            raise ValueError(
                f"chunk start {start} not page-aligned "
                f"(block_size={self.block_size})")
        Tb = self.chunk_bucket(n)
        toks = np.zeros((1, Tb), np.int64)
        toks[0, :n] = token_ids
        tab = np.zeros((1, self.max_blocks_per_seq), np.int32)
        tab[0, :len(table)] = table
        block_ids = np.zeros((Tb,), np.int64)
        block_ids[:n] = tab[0, (start + np.arange(n)) // self.block_size]
        # padded tail positions keep in-range offsets but target page 0
        offsets = (start + np.arange(Tb)) % self.block_size
        dev = self.device
        with self._lock, self._on_mesh():
            k_ctx, v_ctx = self._gather(tab)
            C = k_ctx.shape[2]
            ctx_mask = torch.arange(C, device=dev)[None, :] < start
            chunk_mask = torch.arange(Tb, device=dev)[None, :] < n
            logits, k, v = self.adapter.chunk_fn(
                self._compute, self._tensor(toks), start, k_ctx, v_ctx,
                ctx_mask, chunk_mask, self.cfg)
            self._scatter(k[:, 0], v[:, 0], block_ids, offsets)
            return self._first_token(self._whole(logits[0, n - 1]),
                                     temperature, top_k, top_p)

    @torch.no_grad()
    def decode(self, items: Sequence[DecodeItem]
               ) -> tuple[list[int], np.ndarray]:
        """One decode step for up to max_batch_size sequences; returns
        (next token per item, logits (len(items), Vp))."""
        S = len(items)
        if not 0 < S <= self.max_batch_size:
            raise ValueError(f"decode batch of {S}")
        Sb = self.decode_bucket(S)
        toks = np.zeros((Sb,), np.int64)
        poss = np.zeros((Sb,), np.int32)
        tables = np.zeros((Sb, self.max_blocks_per_seq), np.int32)
        temps = np.zeros((Sb,), np.float32)
        topks = np.zeros((Sb,), np.int32)
        topps = np.ones((Sb,), np.float32)
        for i, it in enumerate(items):
            toks[i] = it.token
            poss[i] = it.pos
            tables[i, :len(it.table)] = it.table
            temps[i] = it.temperature
            topks[i] = it.top_k
            topps[i] = it.top_p
        # the new K/V lands at each lane's own position (padded lanes:
        # page 0, slot 0) after the step
        block_ids = tables[np.arange(Sb), poss // self.block_size]
        offsets = poss % self.block_size
        with self._lock, self._on_mesh():
            tok_t, pos_t = self._tensor(toks), self._tensor(poss)
            if self.use_paged_attention:
                logits, k_new, v_new = self.adapter.decode_paged_fn(
                    self._compute, tok_t, pos_t, self.k_pages,
                    self.v_pages, self._tensor(tables), self.cfg)
            else:
                k_ctx, v_ctx = self._gather(tables)
                C = k_ctx.shape[2]
                ctx_mask = torch.arange(C, device=self.device)[None, :] \
                    < pos_t[:, None]
                logits, k_new, v_new = self.adapter.decode_fn(
                    self._compute, tok_t, pos_t, k_ctx, v_ctx, ctx_mask,
                    self.cfg)
                del k_ctx, v_ctx
            self._scatter(k_new, v_new, block_ids, offsets)
            logits = self._whole(logits)
            nxt = self._sample(logits, temps, topks, topps)
            out = logits[:S].cpu().numpy()
        return [int(t) for t in nxt[:S].tolist()], out

    @torch.no_grad()
    def verify(self, token: int, pos: int, draft: Sequence[int],
               table: Sequence[int], temperature: float,
               top_k: int = 0, top_p: float = 1.0
               ) -> tuple[list[int], torch.Tensor]:
        """Verify a drafted run for one sequence: one step scores `token`
        (at position pos, the frontier) plus up to num_draft_tokens
        drafts at pos+1.., accepts the longest prefix of drafts that
        equal the model's own samples on the device, and returns
        (committed tokens, their logits rows (n, Vp) on the device).
        len(result[0]) is 1 (all rejected) .. len(draft)+1 (full accept
        plus the bonus token); the KV of every committed token is in the
        pages when this returns. Slots past the accepted frontier hold
        garbage that stays masked (the context covers positions < the
        frontier only) and is overwritten as it advances."""
        if not self.spec_width:
            raise RuntimeError("runner built without num_draft_tokens")
        n_draft = len(draft)
        W = self.spec_width
        if not 0 < n_draft < W:
            raise ValueError(f"draft of {n_draft} tokens (max {W - 1})")
        if pos + n_draft >= self.max_model_len:
            raise ValueError(
                f"drafted run past max_model_len: pos {pos} + "
                f"{n_draft} drafts >= {self.max_model_len}")
        toks = np.zeros((1, W), np.int64)
        toks[0, 0] = token
        toks[0, 1:1 + n_draft] = draft
        tab = np.zeros((1, self.max_blocks_per_seq), np.int32)
        tab[0, :len(table)] = table
        positions = pos + np.arange(W)
        # padded tail rows write to the null page at in-range offsets
        block_ids = np.where(
            np.arange(W) <= n_draft,
            tab[0, np.minimum(positions, self.max_model_len - 1)
                // self.block_size], 0)
        offsets = positions % self.block_size
        temps = np.full((W,), temperature, np.float32)
        topks = np.full((W,), top_k, np.int32)
        topps = np.full((W,), top_p, np.float32)
        dev = self.device
        with self._lock, self._on_mesh():
            tok_t = self._tensor(toks)
            if self.use_paged_attention:
                logits, k, v = self.adapter.verify_paged_fn(
                    self._compute, tok_t, pos, self.k_pages, self.v_pages,
                    self._tensor(tab[0]), self.cfg)
            else:
                k_ctx, v_ctx = self._gather(tab)
                C = k_ctx.shape[2]
                ctx_mask = torch.arange(C, device=dev)[None, :] < pos
                chunk_mask = torch.arange(W, device=dev)[None, :] <= n_draft
                logits, k, v = self.adapter.chunk_fn(
                    self._compute, tok_t, pos, k_ctx, v_ctx, ctx_mask,
                    chunk_mask, self.cfg)
                del k_ctx, v_ctx
            self._scatter(k[:, 0], v[:, 0], block_ids, offsets)
            lg = self._whole(logits[0])  # (W, Vp)
            target = self._sample(lg, temps, topks, topps)  # (W,)
            # target[j] is the model's own token for position pos+j+1;
            # keep drafts while they match it, longest-prefix semantics
            match = (target[:-1] == tok_t[0, 1:]) \
                & (torch.arange(W - 1, device=dev) < n_draft)
            n_acc = torch.cumprod(match.long(), dim=0).sum()
            host = torch.cat([target, n_acc[None]]).cpu()  # one copy
        n_em = int(host[-1]) + 1
        return [int(t) for t in host[:n_em].tolist()], lg[:n_em]

    def warmup(self) -> int:
        """Run every step shape once against the null page (prefill and
        chunk length buckets, decode batch buckets, the verify width),
        so that first-call costs (kernel builds, library handles,
        allocator growth) are paid before any request. With chunked
        prefill the engine runs monolithic prefill only on prompts that
        fit one chunk, so both caps are prefill_chunk_size. Returns the
        number of step shapes run."""
        null_table = [0] * self.max_blocks_per_seq
        cap = self.prefill_chunk_size or self.max_model_len
        lengths = [min(self.prefill_bucket_min, cap)]
        while lengths[-1] < cap:
            lengths.append(min(lengths[-1] * 2, cap))
        for b in lengths:
            self.prefill([1] * b, null_table, 0.0)
            if self.prefill_chunk_size is not None:
                self.prefill_chunk([1] * b, 0, null_table, 0.0)
        n = len(lengths) * (1 + (self.prefill_chunk_size is not None))
        s = 1
        while True:
            self.decode([DecodeItem(1, 0, null_table, 0.0)] * s)
            n += 1
            if s >= self.max_batch_size:
                break
            s = min(s * 2, self.max_batch_size)
        if self.spec_width:
            # one fixed-width window covers every draft length
            self.verify(1, 0, [1], null_table, 0.0)
            n += 1
        return n

    def set_params(self, params: Any) -> None:
        """Install a new parameter tree (weight hot-swap). The tree
        structure and leaf shapes must match the resident params; leaves
        are cast to the resident dtypes and moved to the runner's
        device, and on a mesh laid out again by the partition rules, as
        the JAX runner re-shards. The caller guarantees no step is in
        flight (the engine holds its step lock across the swap)."""

        def cast(new, old, path):
            if isinstance(old, dict):
                if not isinstance(new, dict) or set(new) != set(old):
                    raise ValueError(
                        f"param tree mismatch at {path or 'root'}: engine "
                        f"has {sorted(old)}, update has "
                        f"{sorted(new) if isinstance(new, dict) else new}")
                return {k: cast(new[k], old[k], f"{path}/{k}")
                        for k in old}
            if isinstance(new, DTensor):
                new = new.full_tensor()
            t = torch.as_tensor(new).to(self.device, old.dtype)
            if t.shape != old.shape:
                raise ValueError(
                    f"param shape mismatch at {path}: engine has "
                    f"{tuple(old.shape)}, update has {tuple(t.shape)}")
            return t

        self._install(cast(params, self.params, ""))

    def reset_cache(self) -> None:
        """Zero the pages (tests); allocator state lives in BlockPool."""
        with self._lock:
            self._local(self.k_pages).zero_()
            self._local(self.v_pages).zero_()
