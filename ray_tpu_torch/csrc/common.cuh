// Helpers shared by the port's attention kernels: float <-> element
// type conversion, warp reductions, the mask value of the TPU kernels,
// shared-memory opt-in, bf16 packing for the tensor-core operands, and
// the warp-level tensor-core product (mma.sync m16n8k16) with its tile
// staging, which the bf16 kernels at head dim 32 use.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

// ray_tpu/ops/flash_attention.py and paged_attention.py mask with
// -0.7 * float32 max, so a masked logit never overflows exp().
constexpr float kMaskValue = -0.7f * 3.402823466e38f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the element type and back: the TPU kernels cast the
// softmax weights to v's type before the PV product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ------------------------------------------------------- bf16 packing

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two values into one register as bf16, `lo` in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += a b for a 16x16 (row) by 16x8 (col) bf16 tile, f32 accumulate.
// Lane l holds rows l / 4 and l / 4 + 8 of a and c, at columns
// 2 (l % 4) and 2 (l % 4) + 1 of each 8-wide column tile; b0, b1 hold
// rows 2 (l % 4) (+1) and 2 (l % 4) + 8 (+9) of b's column l / 4.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [t0, t0 + ROWS) of a (T, D) slice with row stride `rs` into
// a shared tile whose rows are padded by 8 elements, 32 bits at a time,
// by THREADS threads; rows past `seq` become zero.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long rs, int t0, int seq, int tid) {
  constexpr int kWords = D / 2;
  for (int i = tid; i < ROWS * kWords; i += THREADS) {
    const int r = i / kWords, c = (i % kWords) * 2, t = t0 + r;
    const uint32_t w = t < seq ? ld32(src + t * rs + c) : 0u;
    *reinterpret_cast<uint32_t*>(dst + r * (D + 8) + c) = w;
  }
}

}  // namespace rt
