// K1: flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_fwd` in
// ray_tpu/ops/flash_attention.py: causal (or full) attention over
// q, k, v of shape (B, T, H, D), online softmax with a running row max
// m, row sum l and an f32 accumulator, tiles above the diagonal
// skipped, masked logits at -0.7 * f32 max, rows with l == 0 divided by
// 1. It writes o in the input type and lse = m + log(l) in f32, laid
// out (B, H, T) for the backward kernels of the training slice.
//
// What bounds it: at GPT-2-small prefill (T <= 1024, D = 64) the work
// is ~2 * T^2 * D flops per head against 4 * T * D elements moved, far
// above the card's ops-per-byte line, so it is bound by operations and
// belongs on the tensor cores. The design:
//  - one thread block per (b * h, 64-row q tile); the TPU's sequential
//    k-block grid axis becomes a loop inside the block, and blocks with
//    the longest causal rows start first to even out the tail;
//  - each 64-key k/v tile is read from device memory once per q tile
//    and staged in shared memory;
//  - each of the four warps owns 16 q rows, so the softmax state of a
//    row stays in the registers of the four lanes that hold it and the
//    row max and sum are two shuffles;
//  - bf16 runs both products on the tensor cores with mma.sync
//    m16n8k16 (f32 accumulate): the q k^T accumulators are rounded to
//    bf16 in place and become the A operand of the p v product (the TPU
//    kernel also casts p to v's type), so p never touches shared
//    memory;
//  - f32 runs the same tiling as scalar f32 FMAs from shared memory
//    (TF32 tensor cores would lose the f32 result's digits);
//  - the ragged edge (T not a multiple of 64) is masked, so any T works.
// Strides are passed per tensor, so q, k and v may be column slices of
// one fused qkv projection; the head dimension must be contiguous.
// wgmma, TMA and a producer warp are for a later version.

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kRows = kBlockQ / kWarps;  // q rows owned by one warp

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

// ------------------------------------------------------------- f32 path

template <int D>
constexpr int f32_smem_bytes() {
  return (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kBlockK) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq, int heads, Strides st,
                     float scale, int causal) {
  constexpr int C = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;        // [kBlockK][D + 1]: conflict-free column reads
  float* vs = ks + kBlockK * (D + 1);  // [kBlockK][D]
  float* ps = vs + kBlockK * D;        // [kBlockQ][kBlockK]

  const int n_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, t = q0 + r;
    qs[i] = t < seq ? qb[t * st.qt + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  const float* qw = qs + warp * kRows * D;
  float* pw = ps + warp * kRows * kBlockK;
  const int row0 = q0 + warp * kRows;
  // causal: tiles past the diagonal hold no key any row here may see
  const int last = causal ? qt : n_tiles - 1;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed; qs is loaded
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int r = i / D, d = i % D, t = k0 + r;
      const bool ok = t < seq;
      ks[r * (D + 1) + d] = ok ? kb[t * st.kt + d] : 0.f;
      vs[i] = ok ? vb[t * st.vt + d] : 0.f;
    }
    __syncthreads();

    // s = q k^T for this warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* ka = ks + lane * (D + 1);
    const float* kc = ks + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float x0[4], x1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x0[e] = ka[d + e];
        x1[e] = kc[d + e];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * D + d);
        s[i][0] = fmaf(qv.x, x0[0], fmaf(qv.y, x0[1],
                  fmaf(qv.z, x0[2], fmaf(qv.w, x0[3], s[i][0]))));
        s[i][1] = fmaf(qv.x, x1[0], fmaf(qv.y, x1[1],
                  fmaf(qv.z, x1[2], fmaf(qv.w, x1[3], s[i][1]))));
      }
    }

    // online softmax, row by row across the warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row0 + i;
      float sv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + lane + 32 * c;
        const bool ok = key < seq && (!causal || key <= row);
        sv[c] = ok ? s[i][c] * scale : rt::kMaskValue;
      }
      const float m_new = fmaxf(m[i], rt::warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(sv[0] - m_new);
      const float p1 = expf(sv[1] - m_new);
      l[i] = alpha * l[i] + rt::warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      pw[i * kBlockK + lane] = p0;
      pw[i * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p v over the tile's keys; lane owns columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][C];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < C; ++c) vv[e][c] = vs[(j + e) * D + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(pw + i * kBlockK + j);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[i][c] = fmaf(p.x, vv[0][c], fmaf(p.y, vv[1][c],
                      fmaf(p.z, vv[2][c], fmaf(p.w, vv[3][c], acc[i][c]))));
      }
    }
  }

  // emit o and lse; a row with l == 0 divides by 1
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    if (row >= seq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[lane + 32 * c] = acc[i][c] / ls;
    if (lane == 0) lse[static_cast<long long>(bh) * seq + row] = m[i] + logf(ls);
  }
}

// ------------------------------------------------------------ bf16 path

template <int D>
constexpr int bf16_smem_bytes() {  // q, k, v tiles, rows padded by 8
  return 3 * kBlockQ * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// one 64-row tile of q, k or v into shared memory
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      int t0, int seq, int tid) {
  rt::stage_bf16<D, kBlockQ, kWarps * 32>(dst, src, rs, t0, seq, tid);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int seq, int heads, Strides st, float scale,
                      int causal) {
  constexpr int LD = D + 8;        // padded row, in elements
  constexpr int KS = D / 16;       // k-steps of q k^T over the head dim
  constexpr int NT = kBlockK / 8;  // 8-key column tiles of s
  constexpr int DT = D / 8;        // 8-wide column tiles of o
  extern __shared__ __align__(16) unsigned char tiles[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tiles);
  __nv_bfloat16* ks = qs + kBlockQ * LD;
  __nv_bfloat16* vs = ks + kBlockK * LD;

  const int n_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // mma fragment coordinates: lane holds rows grp and grp + 8 of its
  // warp's 16, at columns 2 * tig and 2 * tig + 1 of each 8-wide tile
  const int grp = lane >> 2, tig = lane & 3;

  stage<D>(qs, q + b * st.qb + h * st.qh, st.qt, q0, seq, tid);
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's q rows as A fragments, kept all along
  {
    const __nv_bfloat16* q_lo = qs + (warp * kRows + grp) * LD + 2 * tig;
    const __nv_bfloat16* q_hi = q_lo + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = rt::ld32(q_lo + kk * 16);
      qf[kk][1] = rt::ld32(q_hi + kk * 16);
      qf[kk][2] = rt::ld32(q_lo + kk * 16 + 8);
      qf[kk][3] = rt::ld32(q_hi + kk * 16 + 8);
    }
  }
  float of[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) of[dt][0] = of[dt][1] = of[dt][2] = of[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * kRows + grp, q0 + warp * kRows + grp + 8};
  const int last = causal ? qt : n_tiles - 1;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, k + b * st.kb + h * st.kh, st.kt, k0, seq, tid);
    stage<D>(vs, v + b * st.vb + h * st.vh, st.vt, k0, seq, tid);
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys per warp, as NT accumulator tiles
    float sf[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sf[nt][0] = sf[nt][1] = sf[nt][2] = sf[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + grp) * LD + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        rt::mma_bf16(sf[nt], qf[kk], rt::ld32(kr + kk * 16), rt::ld32(kr + kk * 16 + 8));
    }

    // mask and scale; element e of a tile is row rows[e / 2], key
    // k0 + 8 nt + 2 tig + e % 2
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const bool ok = key < seq && (!causal || key <= rows[e >> 1]);
        sf[nt][e] = ok ? sf[nt][e] * scale : rt::kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], sf[nt][e]);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(rt::kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(rt::kFullMask, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sf[nt][e] = expf(sf[nt][e] - m[e >> 1]);
        rsum[e >> 1] += sf[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(rt::kFullMask, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(rt::kFullMask, rsum[i], 2);
      l[i] = alpha[i] * l[i] + rsum[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      of[dt][0] *= alpha[0];
      of[dt][1] *= alpha[0];
      of[dt][2] *= alpha[1];
      of[dt][3] *= alpha[1];
    }

    // o += p v, 16 keys per step: two s tiles, rounded to bf16, are
    // exactly one A fragment
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {rt::pack_f32(sf[2 * kk][0], sf[2 * kk][1]),
                              rt::pack_f32(sf[2 * kk][2], sf[2 * kk][3]),
                              rt::pack_f32(sf[2 * kk + 1][0], sf[2 * kk + 1][1]),
                              rt::pack_f32(sf[2 * kk + 1][2], sf[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * tig) * LD + grp;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vc = vr + dt * 8;
        rt::mma_bf16(of[dt], pa, rt::pack_bf16(vc[0], vc[LD]),
                     rt::pack_bf16(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

  // emit o and lse; a row with l == 0 divides by 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= seq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * seq + rows[i]) * heads + h) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          rt::pack_f32(of[dt][2 * i] / ls, of[dt][2 * i + 1] / ls);
    if (tig == 0) lse[static_cast<long long>(bh) * seq + rows[i]] = m[i] + logf(ls);
  }
}

// --------------------------------------------------------------- launch

template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, int smem, const void* q, const void* k,
                   const void* v, void* o, void* lse, int batch, int seq,
                   int heads, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, heads, st, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int batch, int seq, int heads,
                       const Strides& st, float scale, int causal,
                       cudaStream_t stream) {
  static const cudaError_t attr =
      rt::allow_smem(flash_fwd_f32_kernel<D>, f32_smem_bytes<D>());
  if (attr != cudaSuccess) return attr;
  return launch<decltype(&flash_fwd_f32_kernel<D>), float>(
      flash_fwd_f32_kernel<D>, f32_smem_bytes<D>(), q, k, v, o, lse, batch,
      seq, heads, st, scale, causal, stream);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int seq, int heads,
                        const Strides& st, float scale, int causal,
                        cudaStream_t stream) {
  static const cudaError_t attr =
      rt::allow_smem(flash_fwd_bf16_kernel<D>, bf16_smem_bytes<D>());
  if (attr != cudaSuccess) return attr;
  return launch<decltype(&flash_fwd_bf16_kernel<D>), __nv_bfloat16>(
      flash_fwd_bf16_kernel<D>, bf16_smem_bytes<D>(), q, k, v, o, lse,
      batch, seq, heads, st, scale, causal, stream);
}

}  // namespace

// q, k, v: (B, T, H, D) with the strides given (in elements) for the
// batch, time and head axes, D contiguous (bf16: strides even, pointers
// 4-byte aligned); o: (B, T, H, D) contiguous; lse: (B, H, T) f32.
// bf16 != 0 selects __nv_bfloat16, else float. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int batch, int seq,
                            int heads, int head_dim, long long sqb,
                            long long sqt, long long sqh, long long skb,
                            long long skt, long long skh, long long svb,
                            long long svt, long long svh, float scale,
                            int causal, int bf16, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return bf16 ? launch_bf16<64>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s)
                : launch_f32<64>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
  if (head_dim == 128)
    return bf16 ? launch_bf16<128>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s)
                : launch_f32<128>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
