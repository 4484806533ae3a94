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
// by the bytes of the pages it must read, and at a decode batch's size
// (a few MB) by how many of them are in flight at once and by the
// latency of the chain of dependent reads. The design:
//  - the context is split over blocks: one thread-block cluster per (KV
//    head, sequence), whose block i < n_split walks pages [i c, (i + 1) c)
//    of its sequence, c = pages_per_split, and whose last block attends
//    the window's own keys. The plan (n_split, c) comes from host-known
//    shapes only (`split_plan` in ops/paged_attention.py), never from
//    ctx_len, so the launch reads nothing back and can be captured in a
//    CUDA graph; a decode batch fills the SMs even at S = 1;
//  - a split block reads its table entries once (into shared memory, up
//    to kTableCache of them) beside ctx_len, then streams its pages'
//    slices for its KV head (bs rows of D elements, row stride H_kv D)
//    through a ring of kStages tiles with 16-byte cp.async copies,
//    consuming each tile as it lands while the next four are in flight.
//    A tile is KT = min(bs, 32) rows of one page: pages of 8 to 32
//    tokens are one tile each, pages of 64 and 128 tokens two and four,
//    so the ring's shared memory does not grow with the page (five
//    128-token f32 pages at D = 128 would be 640 KB). It never reads
//    tokens at or past ctx_len rounded up to a tile, so a chunk past the
//    context (ctx_len = 0, a padded decode lane, among them) reads
//    nothing and leaves an empty state;
//  - each tile is read once for all H / H_kv grouped query heads and all
//    W window rows: a row's scores and its online softmax in one warp
//    (32 / KT lanes a key), p v one thread per output element, two
//    block barriers a tile; the products stay on the CUDA cores (at
//    W = 1 they are matrix-vector);
//  - each block keeps its partial state (acc (R, D), row max m, row sum
//    l, f32) in its shared memory; after a cluster barrier the blocks
//    merge the states, read from each other's shared memory (DSMEM), in
//    split order, each block a slice of the output, and normalise. One
//    launch, no workspace, no atomics: the result is the same bits on
//    every run. (A second launch for the merge cost ~5 µs on its own on
//    an H100, more than the pages of a decode batch take to read;
//    PERF.md.)
// What bounds it now: latency. A split waits for ctx_len and its table,
// then for its first page, consumes its pages one after another with
// two block barriers each, and the merge waits for the slowest split of
// its cluster.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxWindow = 32;    // largest W
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into
constexpr int kStages = 5;        // tiles in the ring: four in flight, one read
constexpr int kMaxTile = 32;      // page rows a tile: one warp's lanes
constexpr int kThreads = 128;
constexpr int kTableCache = 1024;  // table entries a block keeps in shared memory
constexpr int kMaxCluster = 16;    // blocks of a cluster (H100's non-portable most)

// Page rows a tile of the ring: the whole page up to 32 rows, else 32.
__host__ __device__ constexpr int tile_rows(int bs) { return bs < kMaxTile ? bs : kMaxTile; }

// Shared memory of one block, in bytes (mirrored by smem_bytes in
// ops/paged_attention.py): the ring [kStages][k, v][KT][D] in the
// element type, then in f32 q [R][D], acc [R][D], scores [R][KT], m, l
// and alpha [R], then the chunk's first kTableCache page indices.
inline int smem_bytes(int rows, int d, int bs, int esz, int chunk) {
  const int kt = tile_rows(bs);
  return kStages * 2 * kt * d * esz +
         4 * (2 * rows * d + rows * kt + 3 * rows + (chunk < kTableCache ? chunk : kTableCache));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread of every block of the cluster arrives and waits; what a
// block wrote to its shared memory before is then visible to the others
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `p`, an address in this block's shared memory, read at the same place
// in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// eight consecutive elements from shared memory, as f32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = __bfloat162float(e[u]);
}

// Row r = hr W + w of a KV head's group is query head g rep + hr at
// window position w.
struct Rows {
  int W, H, HK, rep, R;
  __device__ long long q_at(int s, int g, int r) const {
    return (static_cast<long long>(s) * W + r % W) * H + g * rep + r / W;
  }
};

// The own window of one (KV head, sequence): query w sees own keys
// 0..w; one warp a row; the state (acc, m, l) in shared memory.
template <typename T, int D>
__device__ __forceinline__ void own_window(const T* __restrict__ q, const T* __restrict__ own_k,
                                           const T* __restrict__ own_v, float* acc, float* m_s,
                                           float* l_s, int s, int g, const Rows& rw,
                                           float scale) {
  constexpr int C = D / 32;  // columns a lane
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rw.R; r += kThreads / 32) {
    const int w = r % rw.W;
    const T* qr = q + rw.q_at(s, g, r) * D;
    float qv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) qv[c] = rt::to_f(qr[lane + 32 * c]);
    float sc[kMaxWindow];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int x = 0; x < kMaxWindow; ++x) {
      if (x < rw.W) {
        const T* kr = own_k + ((static_cast<long long>(s) * rw.W + x) * rw.HK + g) * D;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) part = fmaf(qv[c], rt::to_f(kr[lane + 32 * c]), part);
        const float dot = rt::warp_sum(part);
        sc[x] = x <= w ? dot * scale : rt::kMaskValue;
        mx = fmaxf(mx, sc[x]);
      }
    }
    float psum = 0.f, pv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) pv[c] = 0.f;
#pragma unroll
    for (int x = 0; x < kMaxWindow; ++x) {
      if (x < rw.W) {
        const T* vr = own_v + ((static_cast<long long>(s) * rw.W + x) * rw.HK + g) * D;
        const float p = expf(sc[x] - mx);
        psum += p;
        const float pr = rt::round_to<T>(p);
#pragma unroll
        for (int c = 0; c < C; ++c) pv[c] = fmaf(pr, rt::to_f(vr[lane + 32 * c]), pv[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r * D + lane + 32 * c] = pv[c];
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = psum;
    }
  }
}

// One cluster per (KV head g, sequence s), blockIdx = (split, g, s):
// block `split` < n_split runs the online softmax over the cached keys
// of pages [split chunk, split chunk + chunk), a tile of KT page rows at
// a time, the last block over the
// own window, each for the R = (H / H_kv) W query rows of the head's
// group; then the blocks merge the states in split order, each a slice
// of the R D outputs.
template <typename T, int D, int BS>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ own_k,
             const T* __restrict__ own_v, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ tables,
             const int* __restrict__ ctx_len, T* __restrict__ out, int W, int H, int HK,
             int max_blocks, int chunk, float scale) {
  constexpr int KT = tile_rows(BS);                       // page rows a tile
  constexpr int TPP = BS / KT;                            // tiles a page
  constexpr int TILE = KT * D;                            // elements of one slice
  constexpr int COPIES = TILE * sizeof(T) / 16;           // 16-byte copies a slice
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int GL = 32 / KT;                             // lanes a key
  constexpr int DL = D / GL;                              // dims a lane
  const int split = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int n_states = gridDim.x;  // the page splits, then the own window
  const Rows rw{W, H, HK, H / HK, (H / HK) * W};
  const int R = rw.R;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * TILE);
  float* acc = qs + R * D;
  float* sc = acc + R * D;
  float* m_s = sc + R * KT;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  int* pages = reinterpret_cast<int*>(a_s + R);

  if (split == n_states - 1) {
    own_window<T, D>(q, own_k, own_v, acc, m_s, l_s, s, g, rw, scale);
  } else {
    const int p0 = split * chunk;
    // the chunk's table entries are fetched beside ctx_len, not after it
    const int* table = tables + static_cast<long long>(s) * max_blocks + p0;
    const int n_table = min(chunk, max_blocks - p0);
    for (int i = tid; i < min(n_table, kTableCache); i += kThreads) pages[i] = table[i];
    const int ctx = max(ctx_len[s], 0);
    const int n_local = min(n_table, min((ctx + BS - 1) / BS, max_blocks) - p0);
    // tiles of the chunk's pages up to ctx_len
    const int n_tiles = n_local > 0 ? (min(n_local * BS, ctx - p0 * BS) + KT - 1) / KT : 0;
    for (int i = tid; i < R * D && n_local > 0; i += kThreads) {
      qs[i] = rt::to_f(q[rw.q_at(s, g, i / D) * D + i % D]);
      acc[i] = 0.f;
    }
    for (int r = tid; r < R; r += kThreads) {  // empty until a page is read
      m_s[r] = -CUDART_INF_F;
      l_s[r] = 0.f;
    }
    __syncthreads();

    // tile i of the chunk (rows (i % TPP) KT.. of its page i / TPP), k
    // and v slices of head g, into stage i % kStages
    const long long row_stride = static_cast<long long>(HK) * D;  // between page rows
    const auto issue = [&](int i) {
      if (i < n_tiles) {
        const int pi = i / TPP;
        const int page = pi < kTableCache ? pages[pi] : table[pi];
        const long long base = (static_cast<long long>(page) * BS + (i % TPP) * KT) * row_stride + g * D;
        T* dst = ring + (i % kStages) * 2 * TILE;
        for (int c = tid; c < 2 * COPIES; c += kThreads) {
          const int kv = c / COPIES, e = (c % COPIES) * VEC;
          const T* src = (kv ? v_pages : k_pages) + base + (e / D) * row_stride + e % D;
          cp_async16(dst + kv * TILE + e, src);
        }
      }
      cp_async_commit();  // one group a tile, empty past the chunk
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile i is in for every thread; stage (i - 1) is free
      issue(i + kStages - 1);
      const T* kp = ring + (i % kStages) * 2 * TILE;
      const T* vp = kp + TILE;
      const int valid = ctx - p0 * BS - i * KT;  // keys of the tile below ctx_len

      // scores and the online softmax, one warp a row: lane (key, part)
      // takes GL = 32 / KT lanes a key, DL = D / GL dims each; p is
      // rounded to the element type before p v, as the TPU kernel casts
      // it to v's type
      for (int r = warp; r < R; r += kThreads / 32) {
        const int key = lane / GL, part = lane % GL;
        const float* qr = qs + r * D + part * DL;
        const T* kr = kp + key * D + part * DL;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DL; c += 8) {
          float x[8], y[8];
          load8(qr + c, x);
          load8(kr + c, y);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(x[e], y[e], dot);
        }
#pragma unroll
        for (int o = 1; o < GL; o <<= 1) dot += __shfl_xor_sync(rt::kFullMask, dot, o);
        const float x = key < valid ? dot * scale : rt::kMaskValue;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, rt::warp_max(x));
        const float p = expf(x - m_new);
        const float psum = rt::warp_sum(part == 0 ? p : 0.f);
        if (part == 0) sc[r * KT + key] = rt::round_to<T>(p);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = alpha * l_s[r] + psum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc alpha + p v, one thread an element
      for (int e = tid; e < R * D; e += kThreads) {
        const int r = e / D, d = e % D;
        const float* pr = sc + r * KT;
        float a = acc[e] * a_s[r];
#pragma unroll
        for (int j = 0; j < KT; ++j) a = fmaf(pr[j], rt::to_f(vp[j * D + d]), a);
        acc[e] = a;
      }
    }
  }
  cluster_sync();  // every block's state is in its shared memory

  // merge: this block's slice of the R D outputs, the states in split
  // order with a running max; an empty state (m = -inf) adds nothing
  for (int e = split * kThreads + tid; e < R * D; e += n_states * kThreads) {
    const int r = e / D;
    float mx = -CUDART_INF_F, a = 0.f, l = 0.f;
    for (int k = 0; k < n_states; ++k) {
      const float m = ld_cluster(m_s + r, k), ls = ld_cluster(l_s + r, k);
      const float x = ld_cluster(acc + e, k);
      const float mn = fmaxf(mx, m);
      const float c_old = mx == -CUDART_INF_F ? 0.f : expf(mx - mn);
      const float c_new = m == -CUDART_INF_F ? 0.f : expf(m - mn);
      a = a * c_old + (c_new != 0.f ? c_new * x : 0.f);
      l = l * c_old + c_new * ls;
      mx = mn;
    }
    out[rw.q_at(s, g, r) * D + e % D] = rt::from_f<T>(a / (l == 0.f ? 1.f : l));
  }
  cluster_sync();  // no block leaves while another still reads its state
}

template <typename T, int D, int BS>
cudaError_t launch(const void* q, const void* own_k, const void* own_v, const void* k_pages,
                   const void* v_pages, const void* tables, const void* ctx_len, void* out,
                   int S, int W, int H, int HK, int max_blocks, int n_split, int chunk,
                   float scale, cudaStream_t stream) {
  const auto kernel = paged_kernel<T, D, BS>;
  static const cudaError_t attr = [&] {
    const cudaError_t err = rt::allow_smem(kernel, kMaxSmem);
    return err != cudaSuccess ? err
                              : cudaFuncSetAttribute(
                                    kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  const int bytes = smem_bytes((H / HK) * W, D, BS, static_cast<int>(sizeof(T)), chunk);
  if (bytes > kMaxSmem || n_split + 1 > kMaxCluster) return cudaErrorInvalidValue;
  // one cluster per (KV head, sequence): the page splits and the own window
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split + 1, HK, S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split + 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(own_k),
      static_cast<const T*>(own_v), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(ctx_len), static_cast<T*>(out), W, H, HK, max_blocks, chunk,
      scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bs(int bs, const void* q, const void* own_k, const void* own_v,
                      const void* k_pages, const void* v_pages, const void* tables,
                      const void* ctx_len, void* out, int S, int W, int H, int HK,
                      int max_blocks, int n_split, int chunk, float scale,
                      cudaStream_t stream) {
  switch (bs) {
    case 8:
      return launch<T, D, 8>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, stream);
    case 16:
      return launch<T, D, 16>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, stream);
    case 32:
      return launch<T, D, 32>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, stream);
    case 64:
      return launch<T, D, 64>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, stream);
    case 128:
      return launch<T, D, 128>(q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// All operands contiguous, in the layout above; bf16 != 0 selects
// __nv_bfloat16, else float. Needs H % H_kv == 0, block_size in
// {8, 16, 32, 64, 128}, W <= 32, D in {32, 64, 128}. Split i < n_split covers pages
// [i chunk, (i + 1) chunk) of each sequence, n_split chunk >= max_blocks
// and n_split + 1 <= 16 (one cluster of blocks per KV head and
// sequence). Returns the CUDA error code of the launch (0 on success).
extern "C" int rt_paged_attention(const void* q, const void* own_k,
                                  const void* own_v, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* ctx_len, void* out, int S,
                                  int W, int H, int HK, int head_dim, int bs,
                                  int max_blocks, float scale, int bf16,
                                  void* stream, int n_split, int chunk) {
  if (HK <= 0 || H % HK || W < 1 || W > kMaxWindow) return cudaErrorInvalidValue;
  if (n_split < 1 || chunk < 1 || static_cast<long long>(n_split) * chunk < max_blocks)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return bf16 ? launch_bs<__nv_bfloat16, 32>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, st)
                : launch_bs<float, 32>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, st);
  if (head_dim == 64)
    return bf16 ? launch_bs<__nv_bfloat16, 64>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, st)
                : launch_bs<float, 64>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, st);
  if (head_dim == 128)
    return bf16 ? launch_bs<__nv_bfloat16, 128>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, st)
                : launch_bs<float, 128>(bs, q, own_k, own_v, k_pages, v_pages, tables, ctx_len, out, S, W, H, HK, max_blocks, n_split, chunk, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
