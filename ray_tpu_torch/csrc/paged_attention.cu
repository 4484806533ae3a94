// K4: paged attention over the serving KV page pool, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_paged_kernel` launched by
// `paged_attention` in ray_tpu/ops/paged_attention.py, with the same
// operand layout: q (S, W, H, D); own_k / own_v (S, W, H_kv, D), the
// window's own keys and values, attended causally within the window;
// k_pages / v_pages (num_blocks, block_size, H_kv, D); tables
// (S, max_blocks) int32; ctx_len (S,) int32. Every query row attends
// the cached slots < ctx_len[s] and then its own window (col <= row),
// with an online softmax, masked logits at -0.7 * f32 max and l == 0
// guarded. Query head h reads KV head h / (H / H_kv).
//
// What bounds it: a decode step does ~4 flops per cached element it
// reads (W = 1), far below the card's ops-per-byte line, so it is bound
// by the bytes of the pages it must read. The design reads each of
// them once and keeps many in flight:
//  - one thread block per (KV head, sequence); it loads each page once
//    for all H / H_kv query heads of its group and all W window rows
//    (the TPU kernel re-reads a page per grouped query head);
//  - the block reads its own table entries and ctx_len from device
//    memory (no scalar prefetch), and never reads pages at or past
//    ceil(ctx_len / block_size), so ctx_len = 0 (a padded decode lane)
//    reads no page at all;
//  - the TPU's sequential page axis becomes eight warps that each walk
//    every eighth page with their own softmax state; the partial states
//    are merged in shared memory before the own window is folded in and
//    the rows normalised;
//  - a warp holds its page in registers: lane (part, j) loads its slice
//    of key row j with 16-byte loads, so a score needs log2(32 / bs)
//    shuffles and the row max and sum log2(bs) each, and lane c loads
//    value column c of every row, so P V needs one shuffle per key.
// TMA and a deeper software pipeline are for a later version.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxWindow = 32;  // largest W
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into

// Shared memory, in floats: q [R][D]; per warp: acc [R][D], m [R], l [R];
// merged: acc [R][D], m [R], l [R].
__host__ __device__ inline int warp_floats(int rows, int d) {
  return rows * d + 2 * rows;
}
__host__ __device__ inline int smem_floats(int rows, int d) {
  return rows * d + kWarps * warp_floats(rows, d) + warp_floats(rows, d);
}

template <typename T, int D, int BS>
__global__ void __launch_bounds__(kWarps * 32)
paged_kernel(const T* __restrict__ q, const T* __restrict__ own_k,
             const T* __restrict__ own_v, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ tables,
             const int* __restrict__ ctx_len, T* __restrict__ out, int W,
             int H, int HK, int max_blocks, float scale) {
  constexpr int C = D / 32;        // value columns per lane
  constexpr int G = 32 / BS;       // lanes sharing one key row
  constexpr int DL = D / G;        // key dims per lane
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements per 16 B
  static_assert(DL % VEC == 0 && DL % 4 == 0, "key slice must be whole 16 B loads");
  const int g = blockIdx.x, s = blockIdx.y;
  const int rep = H / HK, R = rep * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key = lane % BS, part = lane / BS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* states = qs + R * D;
  float* w_acc = states + warp * warp_floats(R, D);
  float* w_m = w_acc + R * D;
  float* w_l = w_m + R;
  float* c_acc = states + kWarps * warp_floats(R, D);
  float* c_m = c_acc + R * D;
  float* c_l = c_m + R;

  // row r = hr * W + w: query head g * rep + hr at window position w
  for (int i = tid; i < R * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, hr = r / W, w = r % W;
    qs[i] = rt::to_f(q[((static_cast<long long>(s) * W + w) * H + g * rep + hr) * D + d]);
  }
  for (int i = lane; i < R * D; i += 32) w_acc[i] = 0.f;
  for (int i = lane; i < R; i += 32) {
    w_m[i] = -CUDART_INF_F;
    w_l[i] = 0.f;
  }
  __syncthreads();

  const long long row_stride = static_cast<long long>(HK) * D;  // between page rows
  const int ctx = max(ctx_len[s], 0);
  const int n_pages = min((ctx + BS - 1) / BS, max_blocks);
  for (int pg = warp; pg < n_pages; pg += kWarps) {
    const long long page = tables[static_cast<long long>(s) * max_blocks + pg];
    const long long base = page * BS * row_stride + static_cast<long long>(g) * D;
    // this lane's slice of key row `key`, and value column lane + 32 c of
    // every row of the page
    float kf[DL];
    const uint4* kr = reinterpret_cast<const uint4*>(
        k_pages + base + key * row_stride + part * DL);
#pragma unroll
    for (int v = 0; v < DL / VEC; ++v) {
      const uint4 raw = kr[v];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VEC; ++u) kf[v * VEC + u] = rt::to_f(e[u]);
    }
    float vf[BS][C];
#pragma unroll
    for (int j = 0; j < BS; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) vf[j][c] = rt::to_f(v_pages[base + j * row_stride + lane + 32 * c]);
    const bool valid = key < ctx - pg * BS;

    for (int r = 0; r < R; ++r) {
      const float* qr = qs + r * D + part * DL;
      float sc = 0.f;
#pragma unroll
      for (int t = 0; t < DL; t += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + t);
        sc = fmaf(qv.x, kf[t], fmaf(qv.y, kf[t + 1], fmaf(qv.z, kf[t + 2], fmaf(qv.w, kf[t + 3], sc))));
      }
#pragma unroll
      for (int o = BS; o < 32; o <<= 1) sc += __shfl_xor_sync(rt::kFullMask, sc, o);
      sc = valid ? sc * scale : rt::kMaskValue;
      float mx = sc;
#pragma unroll
      for (int o = 1; o < BS; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(rt::kFullMask, mx, o));
      const float m_prev = w_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float p = expf(sc - m_new);
      float psum = p;
#pragma unroll
      for (int o = 1; o < BS; o <<= 1) psum += __shfl_xor_sync(rt::kFullMask, psum, o);
      const float pr = rt::round_to<T>(p);
      float pv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) pv[c] = 0.f;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        const float pj = __shfl_sync(rt::kFullMask, pr, j);
#pragma unroll
        for (int c = 0; c < C; ++c) pv[c] = fmaf(pj, vf[j][c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float* a = w_acc + r * D + lane + 32 * c;
        *a = *a * alpha + pv[c];
      }
      __syncwarp();  // every lane has read w_m[r] before lane 0 rewrites it
      if (lane == 0) {
        w_m[r] = m_new;
        w_l[r] = alpha * w_l[r] + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the warps' partial states row by row
  for (int i = tid; i < R * D; i += kWarps * 32) {
    const int r = i / D, d = i % D;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, states[w * warp_floats(R, D) + R * D + r]);
    float a = 0.f, lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* st = states + w * warp_floats(R, D);
      const float mw = st[R * D + r];
      const float f = mw == -CUDART_INF_F ? 0.f : expf(mw - mx);
      a += f * st[i];
      lsum += f * st[R * D + R + r];
    }
    c_acc[i] = a;
    if (d == 0) {
      c_m[r] = mx;
      c_l[r] = lsum;
    }
  }
  __syncthreads();

  // fold in the window's own keys (query w sees own keys 0..w), normalise
  for (int r = warp; r < R; r += kWarps) {
    const int hr = r / W, w = r % W;
    const float* qr = qs + r * D;
    float sc[kMaxWindow];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int x = 0; x < kMaxWindow; ++x) {
      if (x < W) {
        const T* kr = own_k + ((static_cast<long long>(s) * W + x) * HK + g) * D;
        float part_dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) part_dot = fmaf(qr[lane + 32 * c], rt::to_f(kr[lane + 32 * c]), part_dot);
        const float dot = rt::warp_sum(part_dot);
        sc[x] = x <= w ? dot * scale : rt::kMaskValue;
        mx = fmaxf(mx, sc[x]);
      }
    }
    const float m_new = fmaxf(c_m[r], mx);
    const float alpha = expf(c_m[r] - m_new);
    float psum = 0.f, pv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) pv[c] = 0.f;
#pragma unroll
    for (int x = 0; x < kMaxWindow; ++x) {
      if (x < W) {
        const T* vr = own_v + ((static_cast<long long>(s) * W + x) * HK + g) * D;
        const float p = expf(sc[x] - m_new);
        psum += p;
        const float pr = rt::round_to<T>(p);
#pragma unroll
        for (int c = 0; c < C; ++c) pv[c] = fmaf(pr, rt::to_f(vr[lane + 32 * c]), pv[c]);
      }
    }
    const float l = alpha * c_l[r] + psum;
    const float ls = l == 0.f ? 1.f : l;
    T* orow = out + ((static_cast<long long>(s) * W + w) * H + g * rep + hr) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      orow[lane + 32 * c] = rt::from_f<T>((c_acc[r * D + lane + 32 * c] * alpha + pv[c]) / ls);
  }
}

template <typename T, int D, int BS>
cudaError_t launch(const void* q, const void* own_k, const void* own_v,
                   const void* k_pages, const void* v_pages,
                   const void* tables, const void* ctx_len, void* out, int S,
                   int W, int H, int HK, int max_blocks, float scale,
                   cudaStream_t stream) {
  auto kernel = paged_kernel<T, D, BS>;
  static const cudaError_t attr = rt::allow_smem(kernel, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int bytes = smem_floats((H / HK) * W, D) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(HK, S);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(own_k),
      static_cast<const T*>(own_v), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(ctx_len), static_cast<T*>(out), W, H, HK,
      max_blocks, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bs(int bs, const void* q, const void* own_k, const void* own_v,
                      const void* k_pages, const void* v_pages, const void* tables,
                      const void* ctx_len, void* out, int S, int W, int H, int HK,
                      int max_blocks, float scale, cudaStream_t stream) {
  switch (bs) {
    case 8:
      return launch<T, D, 8>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, stream);
    case 16:
      return launch<T, D, 16>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, stream);
    case 32:
      return launch<T, D, 32>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// All operands contiguous, in the layout above; bf16 != 0 selects
// __nv_bfloat16, else float. Needs H % H_kv == 0, block_size in
// {8, 16, 32}, W <= 32, D in {64, 128}. Returns the CUDA error code of
// the launch.
extern "C" int rt_paged_attention(const void* q, const void* own_k,
                                  const void* own_v, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* ctx_len, void* out, int S,
                                  int W, int H, int HK, int head_dim, int bs,
                                  int max_blocks, float scale, int bf16,
                                  void* stream) {
  if (HK <= 0 || H % HK || W < 1 || W > kMaxWindow) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return bf16 ? launch_bs<__nv_bfloat16, 64>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, st)
                : launch_bs<float, 64>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, st);
  if (head_dim == 128)
    return bf16 ? launch_bs<__nv_bfloat16, 128>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, st)
                : launch_bs<float, 128>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
