"""Paged attention over the serving KV page pool: kernel K4, its plain
version, and a launch counter.

The port of ``ray_tpu/ops/paged_attention.py``, with the same operand
layout (one layer at a time):

- ``q``                   (S, W, H, D): W query positions per sequence,
  W=1 for decode, W=K+1 for a speculative verify window;
- ``own_k``/``own_v``     (S, W, H_kv, D): the window's own keys and
  values, never in the pages (the caller scatters them after the step),
  attended causally within the window;
- ``k_pages``/``v_pages`` (num_blocks, block_size, H_kv, D): the pool;
- ``tables``              (S, max_blocks_per_seq) int32: logical page i
  of sequence s lives in physical page ``tables[s, i]`` (padding points
  at the null page 0, which the length mask excludes);
- ``ctx_len``             (S,) int32: positions < ctx_len[s] are cached.

On CUDA tensors `paged_attention` launches K4
(``csrc/paged_attention.cu``, hand-written CUDA C++ for Hopper, sm_90a):
one thread-block cluster per (KV head, sequence), whose blocks each
walk one chunk of the sequence's pages (every page read once for all
of the head's grouped query heads and window rows, several pages in
flight), one more block attending the own window; the blocks then merge
their partial states in order, through each other's shared memory, and
normalise. The chunks come from `split_plan`, which reads shapes only,
never ctx_len, so the launch needs no value from the card and can be
captured in a CUDA graph. On CPU tensors it runs the plain version,
`paged_attention_reference`, the dense oracle of the JAX module (gather
pages through the table, mask by ctx_len, causal own window). There is
no fallback: a CUDA operand the kernel does not take raises.

It has no backward, as in the JAX module: with grad mode on and an
operand that requires grad it raises on either device, where a kernel
launch would otherwise return a result cut off from autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _build
from ray_tpu_torch.ops.attention import on_local_heads

LAUNCHES = _build.LaunchCounter("paged_attention")
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_BLOCK_SIZES = (8, 16, 32, 64, 128)
MAX_WINDOW = 32
MAX_SMEM_BYTES = 232448
# the split plan: a cluster of blocks per (KV head, sequence), the page
# splits and the own window's block, with about seven blocks for each of
# an H100's 132 SMs in all (larger clusters than the card holds at once
# cost more than they gain), at most 15 page splits (a cluster of 16 is
# the H100's most), and at least 64 tokens a split
SPLIT_TARGET_BLOCKS = 7 * 132
MIN_SPLIT_TOKENS = 64
MAX_SPLITS = 15
_TABLE_CACHE = 1024  # table entries a block keeps in shared memory
_STAGES = 5  # tiles in a block's ring
_MAX_TILE = 32  # page rows a tile: a page of up to 32 rows is one tile

_P, _I = ctypes.c_void_p, ctypes.c_int
# rt_paged_attention(q, own_k, own_v, k_pages, v_pages, tables, ctx_len,
# out, S, W, H, H_kv, D, block_size, max_blocks, scale, bf16, stream,
# n_split, pages_per_split)
_ARGTYPES = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P, _I, _I]


def paged_attention_reference(q, own_k, own_v, k_pages, v_pages, tables,
                              ctx_len, *, sm_scale: float | None = None):
    """Dense oracle, same operand layout: every query row attends
    [cached slots < ctx_len[s]] ++ [own window, causally]. Returns
    (S, W, H, D) in q's dtype."""
    S, W, H, D = q.shape
    HK = own_k.shape[2]
    bs = k_pages.shape[1]
    maxB = tables.shape[1]
    C = maxB * bs
    rep = H // HK
    tables = tables.long()
    k_ctx = k_pages[tables].reshape(S, C, HK, D).repeat_interleave(rep, 2)
    v_ctx = v_pages[tables].reshape(S, C, HK, D).repeat_interleave(rep, 2)
    ko = own_k.repeat_interleave(rep, 2)
    vo = own_v.repeat_interleave(rep, 2)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    s_ctx = torch.einsum("swhd,schd->shwc", q, k_ctx).float()
    s_own = torch.einsum("swhd,sxhd->shwx", q, ko).float()
    s = torch.cat([s_ctx, s_own], dim=-1) * scale
    ctx_valid = torch.arange(C, device=q.device)[None, :] \
        < ctx_len.to(q.device).long()[:, None]  # (S, C)
    causal = torch.ones(W, W, dtype=torch.bool, device=q.device).tril()
    valid = torch.cat([ctx_valid[:, None, :].expand(S, W, C),
                       causal[None].expand(S, W, W)], dim=-1)
    s = torch.where(valid[:, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    att = torch.einsum("shwc,schd->swhd", p[..., :C], v_ctx.float()) \
        + torch.einsum("shwx,sxhd->swhd", p[..., C:], vo.float())
    return att.to(q.dtype)


def launch_shape(S: int, W: int, H: int, HK: int) -> str:
    """The label `LAUNCHES.by_shape` counts a launch under: the
    sequences, the window width and the query and KV heads (W=5 is a
    verify window of four drafts; H_kv < H is grouped-query
    attention)."""
    return f"S={S} W={W} H={H} H_kv={HK}"


def split_plan(num_seqs: int, num_kv_heads: int, max_blocks: int,
               block_size: int) -> tuple[int, int]:
    """(n_split, pages_per_split) of K4: split i walks pages
    [i c, (i + 1) c) of each sequence's table, c = pages_per_split; the
    grid of (n_split + 1, H_kv, S) blocks holds about
    SPLIT_TARGET_BLOCKS, in clusters of n_split + 1 <= 16. It depends on
    these shapes only, never on ctx_len, so the launch reads nothing
    back from the card."""
    clusters = max(num_seqs * num_kv_heads, 1)
    want = min(max(SPLIT_TARGET_BLOCKS // clusters - 1, 1), MAX_SPLITS)
    pages = max(-(-max_blocks // want), -(-MIN_SPLIT_TOKENS // block_size))
    pages = max(1, min(pages, max_blocks))
    return -(-max(max_blocks, 1) // pages), pages


def smem_bytes(rows: int, head_dim: int, block_size: int, elem_size: int,
               pages_per_split: int) -> int:
    """Shared memory one block of K4 needs for `rows` = (H / H_kv) * W
    query rows (mirrors `smem_bytes` in the kernel): a ring of _STAGES
    tiles of k and v, a tile being min(block_size, 32) rows of a page, q
    and acc (R, D), scores (R, tile) m, l and alpha (R,) in f32, and its
    chunk's first _TABLE_CACHE table entries."""
    tile = min(block_size, _MAX_TILE)
    ring = _STAGES * 2 * tile * head_dim * elem_size
    return ring + 4 * (2 * rows * head_dim + rows * tile + 3 * rows
                       + min(pages_per_split, _TABLE_CACHE))


def kernel_limit(block_size: int, head_dim: int, window: int, group: int,
                 dtype: torch.dtype, max_blocks: int = _TABLE_CACHE
                 ) -> str | None:
    """The first limit of K4 that a launch with these shapes breaks, in
    words, or None when the kernel takes them: pages of `block_size`
    tokens, `head_dim`, a window of `window` query rows (1 for decode,
    num_draft_tokens + 1 for a speculative verify), `group` = H / H_kv
    query heads a KV head, `dtype`, and tables of `max_blocks` pages (the
    chunk a split walks is at most that, whatever the sequences of a
    launch). Pure: the engine calls it when it is built, so that a
    configuration the kernel cannot take fails there, not at its first
    step."""
    if dtype not in KERNEL_DTYPES:
        return f"dtype {dtype} not in {KERNEL_DTYPES}"
    if head_dim not in KERNEL_HEAD_DIMS:
        return f"head dim {head_dim} not in {KERNEL_HEAD_DIMS}"
    if block_size not in KERNEL_BLOCK_SIZES:
        return f"page size (block_size) {block_size} not in " \
               f"{KERNEL_BLOCK_SIZES}"
    if not 1 <= window <= MAX_WINDOW:
        return f"window W={window} (num_draft_tokens + 1 when " \
               f"speculating) not in 1..{MAX_WINDOW}"
    if group < 1:
        return f"query heads a KV head {group} < 1"
    esz = torch.empty((), dtype=dtype).element_size()
    need = smem_bytes(group * window, head_dim, block_size, esz,
                      max(max_blocks, 1))
    if need > MAX_SMEM_BYTES:
        return f"shared memory: {group} query heads a KV head x W=" \
               f"{window} at head dim {head_dim}, block_size {block_size}" \
               f", {dtype} need {need} bytes a block, over " \
               f"{MAX_SMEM_BYTES}"
    return None


def _check_kernel_operands(q, own_k, own_v, k_pages, v_pages, tables,
                           ctx_len) -> None:
    ops = (q, own_k, own_v, k_pages, v_pages, tables, ctx_len)
    if not all(t.is_cuda and t.device == q.device for t in ops):
        raise ValueError(
            "paged_attention: all operands must lie on one CUDA device "
            "(or all on the CPU)")
    if q.dim() != 4 or own_k.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("paged_attention: q, own_k/v, pages must be 4-D")
    S, W, H, D = q.shape
    NB, bs, HK, Dp = k_pages.shape
    if own_k.shape != (S, W, HK, D) or own_v.shape != own_k.shape:
        raise ValueError(
            f"paged_attention: own_k/own_v {tuple(own_k.shape)}, "
            f"{tuple(own_v.shape)} do not match q {tuple(q.shape)} "
            f"with H_kv={HK}")
    if v_pages.shape != k_pages.shape or Dp != D:
        raise ValueError("paged_attention: page shapes do not match q")
    if tables.dim() != 2 or tables.shape[0] != S \
            or ctx_len.shape != (S,):
        raise ValueError("paged_attention: tables (S, maxB) and ctx_len "
                         "(S,) expected")
    if tables.dtype != torch.int32 or ctx_len.dtype != torch.int32:
        raise ValueError("paged_attention: tables and ctx_len must be "
                         "int32")
    if not all(t.dtype == q.dtype for t in (own_k, own_v, k_pages, v_pages)):
        raise ValueError(
            "paged_attention: the kernel takes one dtype for q, own_k/v and "
            "the pages")
    if H % HK:
        raise ValueError(f"paged_attention: needs H % H_kv == 0, got H={H}, "
                         f"H_kv={HK}")
    limit = kernel_limit(bs, D, W, H // HK, q.dtype, tables.shape[1])
    if limit is not None:
        raise ValueError(f"paged_attention: {limit}")
    if S < 1 or S > 65535:
        raise ValueError(f"paged_attention: S={S} out of the kernel's range")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("paged_attention: operands must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: the kernel reads pages with "
                         "16-byte loads; page tensors must be 16-byte "
                         "aligned")


def paged_attention(q, own_k, own_v, k_pages, v_pages, tables, ctx_len,
                    *, sm_scale: float | None = None) -> torch.Tensor:
    """One layer of paged attention; see the module docstring for the
    operand layout. Returns (S, W, H, D) in q's dtype."""
    ops = (q, own_k, own_v, k_pages, v_pages, tables, ctx_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise RuntimeError(
            "paged_attention has no backward (the JAX module defines no "
            "VJP either): call it under torch.no_grad() or with operands "
            "that do not require grad")
    if all(t.device.type == "cpu" for t in ops):
        return paged_attention_reference(*ops, sm_scale=sm_scale)
    _check_kernel_operands(*ops)
    S, W, H, D = q.shape
    _, bs, HK, _ = k_pages.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    max_blocks = tables.shape[1]
    n_split, pages = split_plan(S, HK, max_blocks, bs)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention")
    fn = _build.bind(lib.rt_paged_attention, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), own_k.data_ptr(), own_v.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
                 ctx_len.data_ptr(), out.data_ptr(), S, W, H, HK, D, bs,
                 max_blocks, float(scale), int(q.dtype == torch.bfloat16),
                 stream, n_split, pages)
    _build.check(err, "paged_attention", _build.bind(
        lib.rt_paged_error_string, [_I], ctypes.c_char_p))
    LAUNCHES.add(launch_shape(S, W, H, HK))
    return out


def _decode_attend(q, k, v, k_pages, v_pages, tables, positions):
    return paged_attention(
        q[:, None].contiguous(), k[:, None].contiguous(),
        v[:, None].contiguous(), k_pages, v_pages, tables, positions)[:, 0]


def _window_attend(q, k, v, k_pages, v_pages, tables, ctx_len):
    return paged_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           k_pages, v_pages, tables, ctx_len)


def decode_hook(k_pages, v_pages, tables, positions):
    """A model block's ``attend(q, k, v)`` for a decode step through K4:
    one query row a sequence, q (B, H, D) with its own k/v (B, H_kv, D),
    over its pages < positions[s] (the kernel's ctx_len) in this layer's
    k_pages/v_pages. Returns (B, H, D). DTensor pages (the serving runner
    on a mesh) launch K4 on each rank's local heads
    (``ops.attention.on_local_heads``, the pages' layout deciding)."""
    def attend(q, k, v):
        return on_local_heads(
            _decode_attend, (q, k, v, k_pages, v_pages, tables, positions),
            (1, 1, 1, 2, 2, None, None), k_pages, 2, 1)

    return attend


def window_hook(k_pages, v_pages, tables, ctx_len):
    """A model block's ``attend(q, k, v)`` for a verify window through
    K4: W query rows q (S, W, H, D) with the window's own k/v
    (S, W, H_kv, D), causally, over the pages < ctx_len[s] in this
    layer's k_pages/v_pages. Returns (S, W, H, D); with DTensor pages,
    on each rank's local heads, as `decode_hook`."""
    def attend(q, k, v):
        return on_local_heads(
            _window_attend, (q, k, v, k_pages, v_pages, tables, ctx_len),
            (2, 2, 2, 2, 2, None, None), k_pages, 2, 2)

    return attend
