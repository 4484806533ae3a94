"""Flash-attention forward: kernel K1, its plain version, and a launch
counter.

The port of the forward half of ``ray_tpu/ops/flash_attention.py``. On
a CUDA tensor `flash_attention` launches K1 (``csrc/flash_attention.cu``,
hand-written CUDA C++ for Hopper, sm_90a); on a CPU tensor it computes
the same function with the plain PyTorch version `_fwd_plain`, which is
also what chip_smoke.py holds the kernel against on the card. There is
no fallback: a CUDA tensor the kernel does not take raises.

`_fwd` returns ``(o, lse)`` with lse laid out (B, H, T) in f32, the
residual the backward kernels will need. The backward (`_dq_kernel`,
`_dkv_kernel` of the JAX module, wrapped in a ``torch.autograd.Function``)
waits for the training slice (ROADMAP.md, queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = _build.LaunchCounter("flash_fwd")
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 9 \
    + [ctypes.c_float, _I, _I, _P]


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
    if q.dtype not in KERNEL_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(
            f"flash_attention: the kernel takes one dtype of "
            f"{KERNEL_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, T, H, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {D} not in {KERNEL_HEAD_DIMS}")
    if T < 1 or B * H < 1 or B * H > 65535:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} "
                         f"out of the kernel's range")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 4 or any(s % 2 for s in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel moves element "
                         "pairs; pointers must be 4-byte aligned and "
                         "strides even")


def _fwd(q, k, v, causal: bool, sm_scale: float):
    """(o (B, T, H, D) in q's dtype, lse (B, H, T) f32): K1 on CUDA
    tensors, `_fwd_plain` on CPU tensors."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, sm_scale)
    _check_kernel_operands(q, k, v)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    fn = _build.bind(lib.rt_flash_fwd, _ARGTYPES)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, T, H, D, *strides, float(sm_scale),
                 int(causal), int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention", _build.bind(
        lib.rt_flash_error_string, [_I], ctypes.c_char_p))
    LAUNCHES.add()
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q, k, v: (B, T, H, D) -> (B, T, H, D), in q's dtype.

    Any T works: the kernel masks the ragged edge (the TPU kernel needs
    T divisible by its block size). Forward only for now."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _fwd(q, k, v, causal, sm_scale)[0]
