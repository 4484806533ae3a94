"""Flash attention, forward and backward: kernels K1, K2 and K3, their
plain versions, launch counters, and the custom operator that joins
them.

The port of ``ray_tpu/ops/flash_attention.py``. On CUDA tensors `_fwd`
launches K1 (``csrc/flash_attention.cu``) and `_bwd` launches K2 (dq)
and K3 (dk, dv) (``csrc/flash_attention_bwd.cu``), hand-written CUDA
C++ for Hopper (sm_90a); on CPU tensors they compute the same functions
with the plain PyTorch versions `_fwd_plain` and `_bwd_plain`, which are
also what chip_smoke.py holds the kernels against on the card. There is
no fallback: a CUDA tensor the kernels do not take raises.

The bf16 K1, K2 and K3 load their tiles with TMA and multiply them with
wgmma, so each operand's base must be 16-byte aligned and its strides
multiples of 16 bytes (`_tma_ok`; the C launch encodes each operand's
tensor map from the strides `_strides` gives). The model's q, k, v
(column slices of the fused qkv projection) meet that and go in as they
are; an operand that does not is copied once into a contiguous tensor
(`_kernel_operand`, counted by `LAYOUT_COPIES`; `do` through
`_kernel_grad_output`), a layout fix and not a fallback.

`flash_attention` goes through the custom operator
``ray_tpu_torch::flash_fwd`` (`flash_fwd`), the counterpart of the JAX
module's custom VJP: it runs `_fwd` and returns ``(o, lse)`` (lse laid
out (B, H, T) in f32), and its registered backward runs `_bwd` on the
saved ``(q, k, v, o, lse)``, so a ``loss.backward()`` on the card
reaches K2 and K3 and on the CPU the plain backward. Being an operator
of its own, and not a Python function around ctypes launches, it is
what a selective-checkpoint policy sees: the remat policies
``save_flash`` and ``save_dots`` of ``models/gpt2.py`` keep its
``(o, lse)`` (JAX names them ``flash_o`` and ``flash_lse``) instead of
launching K1 again in the backward's replay.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = _build.LaunchCounter("flash_fwd")
LAUNCHES_DQ = _build.LaunchCounter("flash_dq")
LAUNCHES_DKV = _build.LaunchCounter("flash_dkv")
# q, k or v copied to a layout TMA can read (not a launch: a count of the
# copies `_kernel_operand` makes, which the model's path must not make)
LAYOUT_COPIES = _build.LaunchCounter("flash_layout_copy")
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (32, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 9 \
    + [ctypes.c_float, _I, _I, _P]
# rt_flash_fwd_rows: rt_flash_fwd's arguments, then the q rows a block
_ROWS_ARGTYPES = _ARGTYPES + [_I]
TMA_ALIGN = 16  # bytes: TMA's rule for the base and every stride
_STRIDES = _L * 12
# rt_flash_dq(q, k, v, do, lse, delta, dq, B, T, H, D, strides, scale,
# causal, bf16, stream); rt_flash_dkv takes dk, dv in place of dq
_DQ_ARGTYPES = [_P] * 7 + [_I] * 4 + [_P, ctypes.c_float, _I, _I, _P]
_DKV_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P, ctypes.c_float, _I, _I, _P]


def _fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """Dense f32 version of K1 on (B, T, H, D): returns o in q's dtype
    and lse (B, H, T) f32, masked like the kernel."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _bwd_plain(q, k, v, o, lse, do, causal: bool, sm_scale: float,
               want_dq: bool = True, want_dkv: bool = True):
    """Dense f32 version of K2 (dq) and K3 (dk, dv) on (B, T, H, D), with
    lse (B, H, T): returns (dq, dk, dv) in q's, k's and v's dtypes, None
    for outputs not wanted. It makes the kernels' casts: ds goes to k's
    (q's) dtype before ds k (ds^T q), p to do's dtype before p^T do, so
    that a bf16 comparison is tight."""
    T = q.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = _delta(o, do)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = dk = dv = None
    if want_dq:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                          kf).to(q.dtype)
    if want_dkv:
        dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                          qf).to(k.dtype)
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(),
                          dof).to(v.dtype)
    return dq, dk, dv


def _delta(o, do):
    """rowsum(do * o) in f32, laid out (B, H, T) like lse: computed
    outside the kernels, as the JAX module does."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def kernel_limit(head_dim: int, dtype: torch.dtype) -> str | None:
    """The first limit of K1, K2 and K3 that a head dim and dtype break,
    in words, or None when the kernels take them (any length T does).
    Pure: the engine calls it when it is built, so that a model the
    kernels cannot serve fails there, not at its first prefill."""
    if dtype not in KERNEL_DTYPES:
        return f"dtype {dtype} not in {KERNEL_DTYPES}"
    if head_dim not in KERNEL_HEAD_DIMS:
        return f"head dim {head_dim} not in {KERNEL_HEAD_DIMS}"
    return None


def _check_kernel_operands(q, k, v) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(
            f"flash_attention: q, k, v must all be CUDA tensors or all CPU "
            f"tensors, got {q.device}, {k.device}, {v.device}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention: q, k, v must share one (B, T, H, D) shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(
            f"flash_attention: the kernel takes one dtype, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    B, T, H, D = q.shape
    limit = kernel_limit(D, q.dtype)
    if limit is not None:
        raise ValueError(f"flash_attention: {limit}")
    if T < 1 or B * H < 1 or B * H > 65535:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} "
                         f"out of the kernel's range")
    if q.dtype == torch.float32 and any(t.stride(-1) != 1
                                        for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")


def _strides(t) -> tuple[int, int, int]:
    """(batch, time, head) strides of a (B, T, H, D) tensor in elements.
    An axis of size 1 gets the stride it would have if the tensor were
    contiguous over the axes inside it: its stride is never followed,
    but TMA checks it."""
    B, T, H, D = t.shape
    sb, st, sh, _ = t.stride()
    if H == 1:
        sh = D
    if T == 1:
        st = H * sh
    if B == 1:
        sb = T * st
    return sb, st, sh


def _tma_ok(t) -> bool:
    """Whether TMA can read `t` as it is: the head dim contiguous, the
    base 16-byte aligned, every stride a positive multiple of 16 bytes
    below 2^40."""
    if t.stride(-1) != 1 or t.data_ptr() % TMA_ALIGN:
        return False
    return all(0 < s * t.element_size() < 2 ** 40
               and s * t.element_size() % TMA_ALIGN == 0
               for s in _strides(t))


def _kernel_operand(t):
    """A bf16 q, k or v as the TMA kernels read it: `t` itself when
    `_tma_ok`, else a contiguous copy in a fresh (aligned) allocation,
    made once and counted in `LAYOUT_COPIES`."""
    if t.dtype != torch.bfloat16 or _tma_ok(t):
        return t
    LAYOUT_COPIES.add()
    return t.clone(memory_format=torch.contiguous_format)


def _fwd(q, k, v, causal: bool, sm_scale: float, block_rows: int = 0):
    """(o (B, T, H, D) in q's dtype, lse (B, H, T) f32): K1 on CUDA
    tensors, `_fwd_plain` on CPU tensors. `block_rows` (64 or 128) fixes
    the bf16 kernel's q rows a block; 0 lets the launch choose by the
    grid's size."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, sm_scale)
    _check_kernel_operands(q, k, v)
    if not sm_scale > 0:
        raise ValueError(f"flash_attention: the kernel takes a positive "
                         f"sm_scale, got {sm_scale}")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    fn = _build.bind(lib.rt_flash_fwd, _ARGTYPES)
    extra = []
    if block_rows:
        fn = _build.bind(lib.rt_flash_fwd_rows, _ROWS_ARGTYPES)
        extra = [int(block_rows)]
    strides = [s for t in (q, k, v) for s in _strides(t)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, T, H, D, *strides, float(sm_scale),
                 int(causal), int(q.dtype == torch.bfloat16), stream, *extra)
    _build.check(err, "flash_attention", _build.bind(
        lib.rt_flash_error_string, [_I], ctypes.c_char_p))
    LAUNCHES.add()
    return o, lse


def _kernel_grad_output(do, q):
    """`do` as the backward kernels take it: q's shape and dtype, the
    head dim contiguous, and for bf16 a layout TMA can read (`_tma_ok`).
    Strides are passed, so the usual gradient (contiguous, or a strided
    view) goes in as it is; only a layout the kernels cannot read is
    copied once."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"flash_attention backward: do {tuple(do.shape)} {do.dtype} on "
            f"{do.device} does not match q {tuple(q.shape)} {q.dtype} on "
            f"{q.device}")
    if do.stride(-1) != 1 or (q.dtype == torch.bfloat16
                              and not _tma_ok(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    return do


def _bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float,
         want_dq: bool = True, want_dkv: bool = True):
    """(dq, dk, dv) in q's, k's and v's dtypes, (B, T, H, D): K2 (dq) and
    K3 (dk, dv) on CUDA tensors, `_bwd_plain` on CPU tensors. A kernel
    whose outputs are not wanted is not launched, and they are None."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return _bwd_plain(q, k, v, o, lse, do, causal, sm_scale,
                          want_dq, want_dkv)
    _check_kernel_operands(q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    do = _kernel_grad_output(do, q)
    B, T, H, _ = q.shape
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or o.shape != q.shape:
        raise ValueError("flash_attention backward: lse must be (B, H, T) "
                         "f32 contiguous and o (B, T, H, D)")
    delta = _delta(o, do)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, sm_scale) \
        if want_dq else None
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale) \
        if want_dkv else (None, None)
    return dq, dk, dv


def _launch_bwd(entry: str, outs, q, k, v, do, lse, delta, causal: bool,
                sm_scale: float) -> None:
    """Launch K2 (``rt_flash_dq``) or K3 (``rt_flash_dkv``) into `outs`
    on operands `_bwd` has checked."""
    B, T, H, D = q.shape
    lib = _build.load("flash_attention_bwd")
    fn = _build.bind(getattr(lib, entry), _DQ_ARGTYPES if len(outs) == 1
                     else _DKV_ARGTYPES)
    strides = _STRIDES(*(s for t in (q, k, v, do) for s in _strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), B, T, H, D,
                 ctypes.cast(strides, _P), float(sm_scale), int(causal),
                 int(q.dtype == torch.bfloat16), stream)
    _build.check(err, entry, _build.bind(
        lib.rt_flash_bwd_error_string, [_I], ctypes.c_char_p))


def _launch_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """K2: dq (B, T, H, D) in q's dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("rt_flash_dq", (dq,), q, k, v, do, lse, delta, causal,
                sm_scale)
    LAUNCHES_DQ.add()
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """K3: (dk, dv) (B, T, H, D) in k's and v's dtypes."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch_bwd("rt_flash_dkv", (dk, dv), q, k, v, do, lse, delta, causal,
                sm_scale)
    LAUNCHES_DKV.add()
    return dk, dv


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (B, T, H, D) in q's dtype, lse (B, H, T) f32) of q, k, v
    (B, T, H, D): K1 on CUDA tensors, the plain version on CPU tensors
    (`_fwd`). Both outputs are contiguous. Differentiable in q, k and v
    through o; lse is the residual the backward reads (as in the JAX
    module, whose VJP has no lse output), and a gradient reaching it is
    not propagated."""
    o, lse = _fwd(q, k, v, causal, sm_scale)
    return o.contiguous(), lse.contiguous()


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, sm_scale):
    B, T, H, D = q.shape
    return (q.new_empty((B, T, H, D)),
            q.new_empty((B, H, T), dtype=torch.float32))


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale


def _flash_backward(ctx, do, _dlse):
    """K2 and K3 (their plain version on the CPU); a kernel whose
    gradients no input needs is not launched."""
    q, k, v, o, lse = ctx.saved_tensors
    want_q, want_k, want_v = ctx.needs_input_grad[:3]
    dq, dk, dv = _bwd(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale,
                      want_dq=want_q, want_dkv=want_k or want_v)
    return (dq if want_q else None, dk if want_k else None,
            dv if want_v else None, None, None)


flash_fwd.register_autograd(_flash_backward,
                            setup_context=_flash_setup_context)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q, k, v: (B, T, H, D) -> (B, T, H, D), in q's dtype.

    Differentiable: the backward runs K2 and K3 on the card and the
    plain backward on the CPU. Any T works: the kernels mask the ragged
    edge (the TPU kernels need T divisible by their block size)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    # refused here, not only in the kernel's launch: on a meta tensor the
    # operator runs its fake kernel, which only propagates shapes
    if not {t.device.type for t in (q, k, v)} <= {"cpu", "cuda"}:
        raise ValueError(f"flash_attention: q, k, v must be CUDA or CPU "
                         f"tensors, got {q.device}, {k.device}, {v.device}")
    return flash_fwd(q, k, v, causal, float(sm_scale))[0]
