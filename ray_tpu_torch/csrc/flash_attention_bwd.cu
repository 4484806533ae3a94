// K2 and K3: flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replace the Pallas TPU kernels `_dq_kernel` (K2) and `_dkv_kernel`
// (K3) launched by `_bwd` in ray_tpu/ops/flash_attention.py. Both
// recompute the softmax weights from the forward's lse instead of
// storing them: p = exp(s * scale - lse), exactly 0 above the diagonal
// and past the ragged edge; with delta = rowsum(do * o) (computed by the
// caller, f32) and dp = do v^T, ds = p (dp - delta) scale. Then
//   K2: dq = ds k                 (ds rounded to k's type first)
//   K3: dv = p^T do, dk = ds^T q  (p rounded to do's type, ds to q's)
// as the TPU kernels do. Two kernels and no atomics, as on the TPU: each
// output tile has one owner block, so the results are deterministic.
//
// What bounds them: at GPT-2-small training (T = 1024, D = 64) each
// runs three (K2) or four (K3) T^2 D products per head against ~5-6
// T D elements moved, far above the card's ops-per-byte line, so they
// are bound by operations and belong on the tensor cores at their full
// rate, which on Hopper only the warpgroup product (wgmma) reaches. Both
// bf16 kernels share one design, in two orientations:
//  - K2 (bf16): one block per (b * h, 128-row q tile), the tiles with
//    the longest causal rows first; two consumer warpgroups of 64 q rows
//    and one producer warpgroup that gives them its registers
//    (setmaxnreg). One producer thread loads the block's q and do tiles
//    once by TMA and streams the k/v tiles (128 keys for D = 64, as in
//    K1; 64 for D = 128) up to the diagonal through a four-stage ring
//    (full/empty mbarriers); both consumer warpgroups read every stage.
//    Each warpgroup keeps lse log2(e) and delta of its accumulator rows
//    in registers and runs, per k/v tile, s = q k^T and dp = do v^T as
//    one group of wgmma (all four operands K-major in shared memory),
//    ds = p (dp - delta) scale in registers, and dq += ds k with ds,
//    rounded to bf16, as the register A operand and k as the MN-major B
//    operand. dq stays in registers and is written once.
//  - K3 (bf16): one block per (b * h, 128-key
//    tile), two consumer warpgroups of 64 keys and one producer
//    warpgroup that gives them its registers (setmaxnreg). k and v are
//    loaded once by TMA and stay in shared memory; one producer thread
//    streams the q and do tiles of the causal range through a two-stage
//    ring (TMA, 4-D tensor maps over (D, H, T, B) from the tensors'
//    strides, full/empty mbarriers) while the producer warp's lanes copy
//    the tiles' lse and delta beside them. Each warpgroup runs four
//    wgmma products per q tile in the transposed orientation:
//    s^T = k q^T and dp^T = v do^T (both operands K-major in shared
//    memory), then dv += p^T do and dk += ds^T q with p^T and ds^T,
//    rounded to bf16 in registers, as the register A operand and do, q
//    as MN-major B operands. dk and dv stay in registers and are written
//    once.
//  - In both, only the tiles on the diagonal or at the ragged edge are
//    masked, and p is exp2 with log2(e) folded into scale and lse. Rows
//    and keys past T arrive from TMA as zeros, and a warpgroup whose
//    rows or keys lie wholly past T, or wholly on the masked side of the
//    diagonal, only releases the stage.
//  - f32 keeps K1's scalar FMA path (TF32 would lose f32's digits), with
//    each warp's p and ds rows passed through shared memory.
//  - bf16 at D = 32 (a 64-byte row, below the 128-byte swizzle the TMA
//    and wgmma layouts here assume) runs the first bf16 design, mma.sync
//    m16n8k16 from padded shared tiles (flash_dq_mma_kernel,
//    flash_dkv_mma_kernel).
//  - The ragged edge (T not a multiple of the tile) is masked, so any T that
//    K1 takes works here.
// Strides are passed per tensor for q, k, v and do (the head dimension
// contiguous), so q, k and v may stay column slices of the fused qkv
// projection; lse and delta are (B, H, T) f32, the outputs (B, T, H, D)
// contiguous.
// What holds them back now: at B=8 T=1024 both run at 130-210 TFLOP/s,
// a fifth of the tensor cores' peak or less; each warpgroup waits on
// every product before the elementwise step that follows it. K2 gained
// nothing from K1's remedies (tile j's products issued beside tile
// j-1's, ping-pong between the warpgroups, one 64-row warpgroup per
// block at two blocks an SM, deeper rings: each within a few per cent,
// most slower; PERF.md), so what remains is neither the loads nor the
// issue order; persistent blocks are the untried step.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;  // q rows and keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlock / kWarps;  // rows owned by one warp

struct Args {
  const void *q, *k, *v, *dout;  // (B, T, H, D), strided
  const float *lse, *delta;      // (B, H, T)
  void *g0, *g1;                 // K2: dq; K3: dk, dv. (B, T, H, D)
  int seq, heads;
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
  float scale;
  int causal;
};

__device__ __forceinline__ long long out_row(const Args& a, int b, int h, int t) {
  return (static_cast<long long>(b) * a.seq + t) * a.heads + h;
}

// p for one (row, key) pair: exactly 0 where the key is masked
__device__ __forceinline__ bool visible(const Args& a, int row, int key) {
  return row < a.seq && key < a.seq && (!a.causal || key <= row);
}

// ------------------------------------------------------------- f32 path

template <int D>
constexpr int dq_f32_smem_bytes() {  // q, do; k, v padded; ds; lse, delta
  return (2 * kBlock * D + 2 * kBlock * (D + 1) + kBlock * kBlock + 2 * kBlock) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(Args a) {
  constexpr int C = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kBlock][D]
  float* dos = qs + kBlock * D;       // [kBlock][D]
  float* ks = dos + kBlock * D;       // [kBlock][D + 1]: conflict-free column reads
  float* vs = ks + kBlock * (D + 1);  // [kBlock][D + 1]
  float* dss = vs + kBlock * (D + 1);  // [kBlock][kBlock]: ds of each warp's rows
  float* lse_s = dss + kBlock * kBlock;
  float* dlt_s = lse_s + kBlock;

  const int seq = a.seq;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = qt * kBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
  const float* kb = static_cast<const float*>(a.k) + b * a.kb + h * a.kh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vb + h * a.vh;
  const float* ob = static_cast<const float*>(a.dout) + b * a.ob + h * a.oh;

  for (int i = tid; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    const bool ok = t < seq;
    qs[i] = ok ? qb[t * a.qt + d] : 0.f;
    dos[i] = ok ? ob[t * a.ot + d] : 0.f;
  }
  for (int r = tid; r < kBlock; r += kThreads) {
    const int t = q0 + r;
    lse_s[r] = t < seq ? a.lse[static_cast<long long>(bh) * seq + t] : 0.f;
    dlt_s[r] = t < seq ? a.delta[static_cast<long long>(bh) * seq + t] : 0.f;
  }

  float acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  const float* qw = qs + warp * kRows * D;
  const float* dw = dos + warp * kRows * D;
  float* sw = dss + warp * kRows * kBlock;
  const int row0 = q0 + warp * kRows;
  const int last = a.causal ? qt : n_tiles - 1;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile is consumed; q, do are loaded
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int r = i / D, d = i % D, t = k0 + r;
      const bool ok = t < seq;
      ks[r * (D + 1) + d] = ok ? kb[t * a.kt + d] : 0.f;
      vs[r * (D + 1) + d] = ok ? vb[t * a.vt + d] : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = do v^T for this warp's rows against keys lane
    // and lane + 32
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    const float* ka = ks + lane * (D + 1);
    const float* kc = ks + (lane + 32) * (D + 1);
    const float* va = vs + lane * (D + 1);
    const float* vc = vs + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float k0v[4], k1v[4], v0v[4], v1v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0v[e] = ka[d + e];
        k1v[e] = kc[d + e];
        v0v[e] = va[d + e];
        v1v[e] = vc[d + e];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(qw + i * D + d);
        const float4 y = *reinterpret_cast<const float4*>(dw + i * D + d);
        s[i][0] = fmaf(x.x, k0v[0], fmaf(x.y, k0v[1], fmaf(x.z, k0v[2], fmaf(x.w, k0v[3], s[i][0]))));
        s[i][1] = fmaf(x.x, k1v[0], fmaf(x.y, k1v[1], fmaf(x.z, k1v[2], fmaf(x.w, k1v[3], s[i][1]))));
        dp[i][0] = fmaf(y.x, v0v[0], fmaf(y.y, v0v[1], fmaf(y.z, v0v[2], fmaf(y.w, v0v[3], dp[i][0]))));
        dp[i][1] = fmaf(y.x, v1v[0], fmaf(y.y, v1v[1], fmaf(y.z, v1v[2], fmaf(y.w, v1v[3], dp[i][1]))));
      }
    }

    // ds = p (dp - delta) scale, p recomputed from lse
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + lane + 32 * c;
        const float p = visible(a, row0 + i, key) ? expf(s[i][c] * a.scale - lse_s[r]) : 0.f;
        sw[i * kBlock + lane + 32 * c] = p * (dp[i][c] - dlt_s[r]) * a.scale;
      }
    }
    __syncwarp();

    // acc += ds k over the tile's keys; lane owns columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < kBlock; j += 4) {
      float kv[4][C];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < C; ++c) kv[e][c] = ks[(j + e) * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 g = *reinterpret_cast<const float4*>(sw + i * kBlock + j);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[i][c] = fmaf(g.x, kv[0][c], fmaf(g.y, kv[1][c],
                      fmaf(g.z, kv[2][c], fmaf(g.w, kv[3][c], acc[i][c]))));
      }
    }
    __syncwarp();
  }

  float* dq = static_cast<float*>(a.g0);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    if (row >= seq) continue;
    float* out = dq + out_row(a, b, h, row) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) out[lane + 32 * c] = acc[i][c];
  }
}

template <int D>
constexpr int dkv_f32_smem_bytes() {  // k, v; q, do padded; p, ds; lse, delta
  return (2 * kBlock * D + 2 * kBlock * (D + 1) + 2 * kBlock * kBlock + 2 * kBlock) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(Args a) {
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [kBlock][D]
  float* vs = ks + kBlock * D;         // [kBlock][D]
  float* qs = vs + kBlock * D;         // [kBlock][D + 1]
  float* dos = qs + kBlock * (D + 1);  // [kBlock][D + 1]
  float* ps = dos + kBlock * (D + 1);  // [kBlock][kBlock]: p^T of each warp's keys
  float* dss = ps + kBlock * kBlock;   // [kBlock][kBlock]: ds^T
  float* lse_s = dss + kBlock * kBlock;
  float* dlt_s = lse_s + kBlock;

  const int seq = a.seq;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  const int kt = blockIdx.x;  // the first k tiles see the most q tiles
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = kt * kBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
  const float* kb = static_cast<const float*>(a.k) + b * a.kb + h * a.kh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vb + h * a.vh;
  const float* ob = static_cast<const float*>(a.dout) + b * a.ob + h * a.oh;

  for (int i = tid; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D, t = k0 + r;
    const bool ok = t < seq;
    ks[i] = ok ? kb[t * a.kt + d] : 0.f;
    vs[i] = ok ? vb[t * a.vt + d] : 0.f;
  }

  float gk[kRows][C], gv[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) gk[i][c] = gv[i][c] = 0.f;
  const float* kw = ks + warp * kRows * D;
  const float* vw = vs + warp * kRows * D;
  float* pw = ps + warp * kRows * kBlock;
  float* sw = dss + warp * kRows * kBlock;
  const int key0 = k0 + warp * kRows;
  // causal: q tiles before this k tile's own hold no row that sees it
  const int first = a.causal ? kt : 0;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile is consumed; k, v are loaded
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int r = i / D, d = i % D, t = q0 + r;
      const bool ok = t < seq;
      qs[r * (D + 1) + d] = ok ? qb[t * a.qt + d] : 0.f;
      dos[r * (D + 1) + d] = ok ? ob[t * a.ot + d] : 0.f;
    }
    for (int r = tid; r < kBlock; r += kThreads) {
      const int t = q0 + r;
      lse_s[r] = t < seq ? a.lse[static_cast<long long>(bh) * seq + t] : 0.f;
      dlt_s[r] = t < seq ? a.delta[static_cast<long long>(bh) * seq + t] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's keys against q rows
    // lane and lane + 32
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    const float* qa = qs + lane * (D + 1);
    const float* qc = qs + (lane + 32) * (D + 1);
    const float* da = dos + lane * (D + 1);
    const float* dc = dos + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float q0v[4], q1v[4], d0v[4], d1v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q0v[e] = qa[d + e];
        q1v[e] = qc[d + e];
        d0v[e] = da[d + e];
        d1v[e] = dc[d + e];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(kw + i * D + d);
        const float4 y = *reinterpret_cast<const float4*>(vw + i * D + d);
        s[i][0] = fmaf(x.x, q0v[0], fmaf(x.y, q0v[1], fmaf(x.z, q0v[2], fmaf(x.w, q0v[3], s[i][0]))));
        s[i][1] = fmaf(x.x, q1v[0], fmaf(x.y, q1v[1], fmaf(x.z, q1v[2], fmaf(x.w, q1v[3], s[i][1]))));
        dp[i][0] = fmaf(y.x, d0v[0], fmaf(y.y, d0v[1], fmaf(y.z, d0v[2], fmaf(y.w, d0v[3], dp[i][0]))));
        dp[i][1] = fmaf(y.x, d1v[0], fmaf(y.y, d1v[1], fmaf(y.z, d1v[2], fmaf(y.w, d1v[3], dp[i][1]))));
      }
    }

    // p^T and ds^T; lse and delta belong to the columns (q rows)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const float p = visible(a, q0 + col, key0 + i) ? expf(s[i][c] * a.scale - lse_s[col]) : 0.f;
        pw[i * kBlock + col] = p;
        sw[i * kBlock + col] = p * (dp[i][c] - dlt_s[col]) * a.scale;
      }
    }
    __syncwarp();

    // gv += p^T do and gk += ds^T q over the tile's q rows; lane owns
    // columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < kBlock; j += 4) {
      float xq[4][C], xo[4][C];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          xq[e][c] = qs[(j + e) * (D + 1) + lane + 32 * c];
          xo[e][c] = dos[(j + e) * (D + 1) + lane + 32 * c];
        }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(pw + i * kBlock + j);
        const float4 g = *reinterpret_cast<const float4*>(sw + i * kBlock + j);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          gv[i][c] = fmaf(p.x, xo[0][c], fmaf(p.y, xo[1][c],
                     fmaf(p.z, xo[2][c], fmaf(p.w, xo[3][c], gv[i][c]))));
          gk[i][c] = fmaf(g.x, xq[0][c], fmaf(g.y, xq[1][c],
                     fmaf(g.z, xq[2][c], fmaf(g.w, xq[3][c], gk[i][c]))));
        }
      }
    }
    __syncwarp();
  }

  float* dk = static_cast<float*>(a.g0);
  float* dv = static_cast<float*>(a.g1);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = key0 + i;
    if (key >= seq) continue;
    const long long o = out_row(a, b, h, key) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[o + lane + 32 * c] = gk[i][c];
      dv[o + lane + 32 * c] = gv[i][c];
    }
  }
}

// ------------------------------------------------------------ bf16 path

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// The bf16 kernels' operands as (B, T, H, D) tensor maps, encoded on the
// host from each operand's strides, with boxes of 64 rows for q and do
// and of `kv_rows` rows for k and v.
cudaError_t make_maps(const Args& a, int batch, int head_dim, int kv_rows, CUtensorMap* q,
                      CUtensorMap* k, CUtensorMap* v, CUtensorMap* dout) {
  cudaError_t err = hop::make_map(q, a.q, batch, a.seq, a.heads, head_dim, a.qb, a.qt, a.qh, 64);
  if (err == cudaSuccess)
    err = hop::make_map(k, a.k, batch, a.seq, a.heads, head_dim, a.kb, a.kt, a.kh, kv_rows);
  if (err == cudaSuccess)
    err = hop::make_map(v, a.v, batch, a.seq, a.heads, head_dim, a.vb, a.vt, a.vh, kv_rows);
  if (err == cudaSuccess)
    err = hop::make_map(dout, a.dout, batch, a.seq, a.heads, head_dim, a.ob, a.ot, a.oh, 64);
  return err;
}

// K2, bf16: one block per (b * h, 128-row q tile); two consumer
// warpgroups of 64 q rows each and one producer warpgroup; k/v tiles of
// BN keys.
//
// Shared memory from a 1024-byte aligned base: the block's q and do
// (one 64-row tile of each per consumer warpgroup), kStages k and v
// tiles of BN keys, then the barriers q_full, full[kStages],
// empty[kStages].
template <int D, int BN>
struct DqLayout {
  static constexpr int kWG = 2;  // consumer warpgroups, 64 q rows each
  static constexpr int kStages = 4;
  static constexpr int kQ = hop::tile_bytes<D>(64);
  static constexpr int kKV = hop::tile_bytes<D>(BN);
  static constexpr int do_off = kWG * kQ;
  static constexpr int k_off = 2 * kWG * kQ;
  static constexpr int v_off = k_off + kStages * kKV;
  static constexpr int bar_off = v_off + kStages * kKV;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;  // + alignment
  static constexpr int kThreads = (kWG + 1) * 128;
  // 384 threads launch with 168 registers; 128 * 40 + 256 * 232 of them
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
};

struct DqParams {
  CUtensorMap q, k, v, dout;  // (B, T, H, D) maps, boxes of 64 (q, do) and BN (k, v) rows
  const float *lse, *delta;  // (B, H, T)
  bf16* dq;                  // (B, T, H, D) contiguous
  int seq, heads, causal;
  float scale;
};

template <int D, int BN>
__global__ void __launch_bounds__(DqLayout<D, BN>::kThreads, 1)
flash_dq_bf16_kernel(const __grid_constant__ DqParams p) {
  using L = DqLayout<D, BN>;
  constexpr int S = L::kStages;
  constexpr int NK = BN / 16;  // k16 steps of dq += ds k
  extern __shared__ __align__(1024) unsigned char ring[];
  const uint32_t base = (hop::smem_addr(ring) + 1023) & ~1023u;
  const uint32_t q_full = base + L::bar_off;
  const auto full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + S + s); };

  const int seq = p.seq;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  // the q tiles with the longest causal rows first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kWG * 64;
  // causal: k tiles past the block's last row hold no key it may see
  const int n_k = p.causal ? (min(q0 + L::kWG * 64, seq) - 1) / BN + 1 : (seq + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(full(s), 1);
      hop::mbar_init(empty(s), L::kWG * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == L::kWG) {
    // producer: one thread loads q and do once, for the warpgroups whose
    // rows start before T, then streams the k/v tiles through the ring
    hop::regs_dec<L::kProducerRegs>();
    if (threadIdx.x == L::kWG * 128) {
      const int live = min(L::kWG, (seq - q0 + 63) / 64);
      hop::mbar_arrive_expect_tx(q_full, 2 * live * L::kQ);
      for (int w = 0; w < live; ++w) {
        hop::tma_tile<D>(base + w * L::kQ, &p.q, q_full, 64, h, q0 + 64 * w, b);
        hop::tma_tile<D>(base + L::do_off + w * L::kQ, &p.dout, q_full, 64, h, q0 + 64 * w, b);
      }
      for (int j = 0; j < n_k; ++j) {
        const int s = j % S;
        hop::mbar_wait(empty(s), ((j / S) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(full(s), 2 * L::kKV);
        hop::tma_tile<D>(base + L::k_off + s * L::kKV, &p.k, full(s), BN, h, BN * j, b);
        hop::tma_tile<D>(base + L::v_off + s * L::kKV, &p.v, full(s), BN, h, BN * j, b);
      }
    }
  } else {
    // consumer warpgroup `wg`: q rows qw .. qw + 63
    hop::regs_inc<L::kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int grp = lane / 4, tig = lane % 4;
    const int qw = q0 + 64 * wg;
    const int rows[2] = {qw + 16 * warp + grp, qw + 16 * warp + grp + 8};
    const uint32_t q_tile = base + wg * L::kQ, do_tile = base + L::do_off + wg * L::kQ;
    const float scale_log2 = p.scale * kLog2e;
    // lse (times log2 e) and delta of this thread's two accumulator rows
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = static_cast<long long>(bh) * seq + rows[r];
      lse2[r] = rows[r] < seq ? p.lse[at] * kLog2e : 0.f;
      dlt[r] = rows[r] < seq ? p.delta[at] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    hop::mbar_wait(q_full, 0);

    const auto k_tile = [&](int j) { return base + L::k_off + (j % S) * L::kKV; };
    uint32_t da[NK][4];  // ds of the tile, the A operand of dq += ds k
    for (int j = 0; j < n_k; ++j) {
      const int k0 = BN * j;
      // a warpgroup past T, or whose rows all lie before this tile's
      // keys, has no work on it and only releases the stage
      const bool work = qw < seq && !(p.causal && k0 > qw + 63);
      const uint32_t v_tile = base + L::v_off + (j % S) * L::kKV;
      hop::mbar_wait(full(j % S), (j / S) & 1);

      // s = q k^T and dp = do v^T, all four operands K-major, one group
      float sc[BN / 2], dp[BN / 2];
      hop::fence_regs(dq);
      hop::wgmma_fence();
      if (work) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hop::wgmma_ss<0>(sc, hop::desc_k(q_tile, 64, kk), hop::desc_k(k_tile(j), BN, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hop::wgmma_ss<0>(dp, hop::desc_k(do_tile, 64, kk), hop::desc_k(v_tile, BN, kk), kk);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);

      // ds = p (dp - delta) scale with p = exp2(s scale log2 e - lse
      // log2 e), exactly 0 where the key is masked, which only a tile
      // on the diagonal or at the ragged edge holds. Element i: row
      // rows[(i >> 1) & 1], key k0 + 8 (i / 4) + 2 tig + (i & 1).
      if (work) {
        const bool edge = (p.causal && k0 + BN - 1 > qw) || k0 + BN > seq;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1, key = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
          const float pv = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
          const bool ok = !edge || (key < seq && (!p.causal || key <= rows[r]));
          sc[i] = ok ? pv * (dp[i] - dlt[r]) * p.scale : 0.f;
        }
      }
      // ds rounded to bf16 (k's type): two accumulator column blocks are
      // one A fragment of a k16 step over the keys
      if (work) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          da[kk][0] = rt::pack_f32(sc[8 * kk], sc[8 * kk + 1]);
          da[kk][1] = rt::pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
          da[kk][2] = rt::pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
          da[kk][3] = rt::pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      }
      // dq += ds k, k MN-major (its rows are the keys)
      if (work) {
        hop::fence_regs(dq);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          hop::wgmma_rs<1>(dq, da[kk], hop::desc_mn(k_tile(j), BN, kk), 1);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(dq);
        hop::fence_frag(da);
      }
      hop::mbar_arrive(empty(j % S));
    }

    // dq, written once, in bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= seq) continue;
      const long long at = ((static_cast<long long>(b) * seq + rows[r]) * p.heads + h) * D + 2 * tig;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(p.dq + at + 8 * jj) =
            rt::pack_f32(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
    }
  }
}

// K3, bf16: one block per (b * h, 128-key tile); two consumer
// warpgroups of 64 keys each and one producer warpgroup.

// Shared memory from a 1024-byte aligned base: the block's k and v (two
// 64-row tiles each, one per consumer warpgroup), kStages q and do
// tiles of 64 rows, kStages rows of lse (times log2 e) and delta, then
// the barriers kv_full, full[kStages], empty[kStages].
template <int D>
struct DkvLayout {
  static constexpr int kWG = 2;  // consumer warpgroups, 64 keys each
  static constexpr int kStages = 2;
  static constexpr int kT = hop::tile_bytes<D>(64);
  static constexpr int v_off = kWG * kT;
  static constexpr int q_off = 2 * kWG * kT;
  static constexpr int do_off = q_off + kStages * kT;
  static constexpr int rows_off = do_off + kStages * kT;  // float [kStages][2][64]
  static constexpr int bar_off = rows_off + kStages * 2 * 64 * 4;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;  // + alignment
  static constexpr int kThreads = (kWG + 1) * 128;
  // 384 threads launch with 168 registers; 128 * 40 + 256 * 232 of them
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
};

struct DkvParams {
  CUtensorMap q, k, v, dout;  // (B, T, H, D) maps, boxes of 64 rows
  const float *lse, *delta;   // (B, H, T)
  bf16 *dk, *dv;              // (B, T, H, D) contiguous
  int seq, heads, causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(DkvLayout<D>::kThreads, 1)
flash_dkv_bf16_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char ring[];
  const uint32_t raw = hop::smem_addr(ring);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* rows_s = reinterpret_cast<float*>(ring + (base - raw) + L::rows_off);
  const uint32_t kv_full = base + L::bar_off;
  const auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return kv_full + 8 * (1 + S + s); };

  const int seq = p.seq;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * L::kWG * 64;  // the first k tiles see the most q tiles
  const int n_qt = (seq + kBlock - 1) / kBlock;
  // causal: q tiles before this k tile hold no row that sees its keys
  const int first = p.causal ? k0 / kBlock : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(full(s), 1 + 32);  // the TMA thread, then each lane's lse/delta
      hop::mbar_init(empty(s), L::kWG * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == L::kWG) {
    // producer warp: lane 0 issues the TMA loads, every lane copies two
    // entries of lse and of delta for each q tile
    hop::regs_dec<L::kProducerRegs>();
    const int lane = threadIdx.x % 128;
    if (lane < 32) {
      if (lane == 0) {
        hop::mbar_arrive_expect_tx(kv_full, 2 * L::kWG * L::kT);
        for (int w = 0; w < L::kWG; ++w) {
          hop::tma_tile<D>(base + w * L::kT, &p.k, kv_full, 64, h, k0 + 64 * w, b);
          hop::tma_tile<D>(base + L::v_off + w * L::kT, &p.v, kv_full, 64, h, k0 + 64 * w, b);
        }
      }
      const long long row0 = static_cast<long long>(bh) * seq;
      for (int i = 0; i < n_qt - first; ++i) {
        const int s = i % S, q0 = (first + i) * kBlock;
        hop::mbar_wait(empty(s), ((i / S) & 1) ^ 1);
        if (lane == 0) {
          hop::mbar_arrive_expect_tx(full(s), 2 * L::kT);
          hop::tma_tile<D>(base + L::q_off + s * L::kT, &p.q, full(s), 64, h, q0, b);
          hop::tma_tile<D>(base + L::do_off + s * L::kT, &p.dout, full(s), 64, h, q0, b);
        }
        float* lse_s = rows_s + s * 128;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = lane + 32 * c, t = q0 + r;
          lse_s[r] = t < seq ? p.lse[row0 + t] * kLog2e : 0.f;
          lse_s[64 + r] = t < seq ? p.delta[row0 + t] : 0.f;
        }
        hop::mbar_arrive(full(s));
      }
    }
  } else {
    // consumer warpgroup `wg`: keys kw .. kw + 63
    hop::regs_inc<L::kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int grp = lane / 4, tig = lane % 4;
    const int kw = k0 + 64 * wg;
    const int keys[2] = {kw + 16 * warp + grp, kw + 16 * warp + grp + 8};
    const uint32_t k_tile = base + wg * L::kT, v_tile = base + L::v_off + wg * L::kT;
    const float scale_log2 = p.scale * kLog2e;
    float gk[D / 2], gv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
    hop::mbar_wait(kv_full, 0);

    for (int i = 0; i < n_qt - first; ++i) {
      const int s = i % S, q0 = (first + i) * kBlock;
      hop::mbar_wait(full(s), (i / S) & 1);
      // a warpgroup past T, or whose keys all lie after this tile's rows,
      // only releases the stage
      if (kw < seq && !(p.causal && q0 + kBlock - 1 < kw)) {
        const uint32_t q_tile = base + L::q_off + s * L::kT;
        const uint32_t do_tile = base + L::do_off + s * L::kT;
        const float* lse_s = rows_s + s * 128;
        const float* dlt_s = lse_s + 64;

        // s^T = k q^T: keys as rows, q rows as columns
        float st[32];
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hop::wgmma_ss<0>(st, hop::desc_k(k_tile, 64, kk), hop::desc_k(q_tile, 64, kk), kk);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(st);

        // p^T = exp2(s^T scale log2 e - lse log2 e); exactly 0 where the
        // key is masked, which only a tile on the diagonal or at the
        // ragged edge holds. Element i: key keys[(i >> 1) & 1], q row
        // q0 + 8 (i / 4) + 2 tig + (i & 1).
        const bool edge = (p.causal && q0 < kw + 63) || q0 + kBlock > seq;
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) {
          const int col = 8 * (i2 / 4) + 2 * tig + (i2 & 1);
          const float pv = exp2f(st[i2] * scale_log2 - lse_s[col]);
          const bool ok = !edge || (q0 + col < seq &&
                                    (!p.causal || keys[(i2 >> 1) & 1] <= q0 + col));
          st[i2] = ok ? pv : 0.f;
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = rt::pack_f32(st[8 * kk], st[8 * kk + 1]);
          pa[kk][1] = rt::pack_f32(st[8 * kk + 2], st[8 * kk + 3]);
          pa[kk][2] = rt::pack_f32(st[8 * kk + 4], st[8 * kk + 5]);
          pa[kk][3] = rt::pack_f32(st[8 * kk + 6], st[8 * kk + 7]);
        }
        // dv += p^T do (p rounded to bf16, do MN-major) and
        // dp^T = v do^T (both K-major), in one group
        float dpt[32];
        hop::fence_regs(gv);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_rs<1>(gv, pa[kk], hop::desc_mn(do_tile, 64, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hop::wgmma_ss<0>(dpt, hop::desc_k(v_tile, 64, kk), hop::desc_k(do_tile, 64, kk), kk);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(gv);
        hop::fence_regs(dpt);
        hop::fence_frag(pa);

        // ds^T = p^T (dp^T - delta) scale, rounded to bf16 (q's type)
        uint32_t da[4][4];
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) {
          const int col = 8 * (i2 / 4) + 2 * tig + (i2 & 1);
          st[i2] *= (dpt[i2] - dlt_s[col]) * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          da[kk][0] = rt::pack_f32(st[8 * kk], st[8 * kk + 1]);
          da[kk][1] = rt::pack_f32(st[8 * kk + 2], st[8 * kk + 3]);
          da[kk][2] = rt::pack_f32(st[8 * kk + 4], st[8 * kk + 5]);
          da[kk][3] = rt::pack_f32(st[8 * kk + 6], st[8 * kk + 7]);
        }
        // dk += ds^T q, q MN-major
        hop::fence_regs(gk);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_rs<1>(gk, da[kk], hop::desc_mn(q_tile, 64, kk), 1);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(gk);
        hop::fence_frag(da);
      }
      hop::mbar_arrive(empty(s));
    }

    // dk and dv, written once, in bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= seq) continue;
      const long long at = ((static_cast<long long>(b) * seq + keys[r]) * p.heads + h) * D + 2 * tig;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(p.dk + at + 8 * jj) =
            rt::pack_f32(gk[4 * jj + 2 * r], gk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + at + 8 * jj) =
            rt::pack_f32(gv[4 * jj + 2 * r], gv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------- bf16 at head dim 32

// A 32-column bf16 row is 64 bytes, half the 128-byte swizzle span that
// the TMA boxes and wgmma descriptors of the kernels above are built on.
// At D = 32 (the tiny presets, test-sized) K2 and K3 in bf16 run the
// warp-level design instead: one block per (b * h, 64-row tile), four
// warps of 16 rows, mma.sync m16n8k16 with f32 accumulate. K2 keeps q
// and do as A fragments and loops over the k/v tiles up to the diagonal;
// K3 keeps k and v as A fragments and loops over the q/do tiles from the
// diagonal down, in the transposed orientation, so that p, p^T, ds and
// ds^T stay in registers as the A operands of the next products. Tiles
// are staged in shared memory with rows padded by 8 elements;
// synchronous loads.

template <int D>
constexpr int mma_smem_bytes() {  // four 64-row tiles, rows padded by 8
  return 4 * kBlock * (D + 8) * static_cast<int>(sizeof(bf16)) +
         2 * kBlock * static_cast<int>(sizeof(float));
}

template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long rs,
                                      int t0, int seq, int tid) {
  rt::stage_bf16<D, kBlock, kThreads>(dst, src, rs, t0, seq, tid);
}

// A fragments of this warp's 16 rows of a staged tile (row-major, 16
// columns per k-step)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4], const bf16* tile,
                                       int warp, int grp, int tig) {
  constexpr int LD = D + 8;
  const bf16* lo = tile + (warp * kRows + grp) * LD + 2 * tig;
  const bf16* hi = lo + 8 * LD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = rt::ld32(lo + kk * 16);
    f[kk][1] = rt::ld32(hi + kk * 16);
    f[kk][2] = rt::ld32(lo + kk * 16 + 8);
    f[kk][3] = rt::ld32(hi + kk * 16 + 8);
  }
}

// acc = a x^T over the head dim: a's 16 rows (fragments `a`) against
// the 64 rows of the staged tile `x`, as 8 accumulator tiles of 8
// columns
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[kBlock / 8][4],
                                             const uint32_t (&a)[D / 16][4],
                                             const bf16* x, int grp, int tig) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < kBlock / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* xr = x + (nt * 8 + grp) * LD + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      rt::mma_bf16(acc[nt], a[kk], rt::ld32(xr + kk * 16), rt::ld32(xr + kk * 16 + 8));
  }
}

// out += w x: the 16 x 64 weights `w` (accumulator layout, rounded to
// bf16 here) against the staged 64-row tile `x` in [row, d] orientation
template <int D>
__device__ __forceinline__ void weights_by_tile(float (&out)[D / 8][4],
                                                const float (&w)[kBlock / 8][4],
                                                const bf16* x, int grp, int tig) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    // two accumulator tiles, rounded to bf16, are exactly one A fragment
    const uint32_t wa[4] = {rt::pack_f32(w[2 * kk][0], w[2 * kk][1]),
                            rt::pack_f32(w[2 * kk][2], w[2 * kk][3]),
                            rt::pack_f32(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                            rt::pack_f32(w[2 * kk + 1][2], w[2 * kk + 1][3])};
    const bf16* xr = x + (kk * 16 + 2 * tig) * LD + grp;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const bf16* xc = xr + dt * 8;
      rt::mma_bf16(out[dt], wa, rt::pack_bf16(xc[0], xc[LD]),
                   rt::pack_bf16(xc[8 * LD], xc[9 * LD]));
    }
  }
}

// rows `rows[0]`, `rows[1]` of an accumulator in (B, T, H, D) layout
template <int D>
__device__ __forceinline__ void store_rows(const Args& a, void* base, int b, int h,
                                           const int (&rows)[2],
                                           const float (&acc)[D / 8][4], int tig) {
  bf16* out = static_cast<bf16*>(base);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.seq) continue;
    bf16* r = out + out_row(a, b, h, rows[i]) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(r + dt * 8) = rt::pack_f32(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_mma_kernel(Args a) {
  constexpr int LD = D + 8, NT = kBlock / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tiles[];
  bf16* qs = reinterpret_cast<bf16*>(tiles);
  bf16* dos = qs + kBlock * LD;
  bf16* ks = dos + kBlock * LD;
  bf16* vs = ks + kBlock * LD;

  const int seq = a.seq;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = qt * kBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;

  stage_tile<D>(qs, static_cast<const bf16*>(a.q) + b * a.qb + h * a.qh, a.qt, q0, seq, tid);
  stage_tile<D>(dos, static_cast<const bf16*>(a.dout) + b * a.ob + h * a.oh, a.ot, q0, seq,
           tid);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];  // kept all along
  load_a<D>(qf, qs, warp, grp, tig);
  load_a<D>(df, dos, warp, grp, tig);
  const int rows[2] = {q0 + warp * kRows + grp, q0 + warp * kRows + grp + 8};
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * seq + rows[i];
    lse[i] = rows[i] < seq ? a.lse[at] : 0.f;
    dlt[i] = rows[i] < seq ? a.delta[at] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  const int last = a.causal ? qt : n_tiles - 1;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.kb + h * a.kh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vb + h * a.vh;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile is consumed
    stage_tile<D>(ks, kb, a.kt, k0, seq, tid);
    stage_tile<D>(vs, vb, a.vt, k0, seq, tid);
    __syncthreads();

    float sf[NT][4], dpf[NT][4];
    rows_by_rows<D>(sf, qf, ks, grp, tig);   // s = q k^T
    rows_by_rows<D>(dpf, df, vs, grp, tig);  // dp = do v^T
    // element e of tile nt: row rows[e / 2], key k0 + 8 nt + 2 tig + e % 2
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const float p = visible(a, rows[e >> 1], key) ? expf(sf[nt][e] * a.scale - lse[e >> 1]) : 0.f;
        sf[nt][e] = p * (dpf[nt][e] - dlt[e >> 1]) * a.scale;  // ds
      }
    weights_by_tile<D>(acc, sf, ks, grp, tig);  // dq += ds k
  }
  store_rows<D>(a, a.g0, b, h, rows, acc, tig);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma_kernel(Args a) {
  constexpr int LD = D + 8, NT = kBlock / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tiles[];
  bf16* ks = reinterpret_cast<bf16*>(tiles);
  bf16* vs = ks + kBlock * LD;
  bf16* qs = vs + kBlock * LD;
  bf16* dos = qs + kBlock * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kBlock * LD);
  float* dlt_s = lse_s + kBlock;

  const int seq = a.seq;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  const int kt = blockIdx.x;  // the first k tiles see the most q tiles
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = kt * kBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;

  stage_tile<D>(ks, static_cast<const bf16*>(a.k) + b * a.kb + h * a.kh, a.kt, k0, seq, tid);
  stage_tile<D>(vs, static_cast<const bf16*>(a.v) + b * a.vb + h * a.vh, a.vt, k0, seq, tid);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];  // kept all along
  load_a<D>(kf, ks, warp, grp, tig);
  load_a<D>(vf, vs, warp, grp, tig);
  const int keys[2] = {k0 + warp * kRows + grp, k0 + warp * kRows + grp + 8};
  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[dt][e] = gv[dt][e] = 0.f;
  const int first = a.causal ? kt : 0;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qb + h * a.qh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.ob + h * a.oh;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile is consumed
    stage_tile<D>(qs, qb, a.qt, q0, seq, tid);
    stage_tile<D>(dos, ob, a.ot, q0, seq, tid);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int t = q0 + r;
      lse_s[r] = t < seq ? a.lse[static_cast<long long>(bh) * seq + t] : 0.f;
      dlt_s[r] = t < seq ? a.delta[static_cast<long long>(bh) * seq + t] : 0.f;
    }
    __syncthreads();

    float sf[NT][4], dpf[NT][4];
    rows_by_rows<D>(sf, kf, qs, grp, tig);  // s^T = k q^T
    // element e of tile nt: key keys[e / 2], q row q0 + 8 nt + 2 tig + e % 2
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        sf[nt][e] = visible(a, q0 + col, keys[e >> 1])
                        ? expf(sf[nt][e] * a.scale - lse_s[col]) : 0.f;  // p^T
      }
    weights_by_tile<D>(gv, sf, dos, grp, tig);  // dv += p^T do
    rows_by_rows<D>(dpf, vf, dos, grp, tig);    // dp^T = v do^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        sf[nt][e] *= (dpf[nt][e] - dlt_s[col]) * a.scale;  // ds^T
      }
    weights_by_tile<D>(gk, sf, qs, grp, tig);  // dk += ds^T q
  }
  store_rows<D>(a, a.g0, b, h, keys, gk, tig);
  store_rows<D>(a, a.g1, b, h, keys, gv, tig);
}

// --------------------------------------------------------------- launch

// Each kernel is opted into its shared memory once, at its first launch.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, cudaError_t attr, const Args& a,
                   int batch, cudaStream_t stream) {
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.seq + kBlock - 1) / kBlock, batch * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// K2 in bf16: the tensor maps are encoded here, on every call, and
// passed by value
template <int D, int BN>
cudaError_t launch_dq_bf16(const Args& a, int batch, cudaStream_t stream) {
  using L = DqLayout<D, BN>;
  const auto kernel = flash_dq_bf16_kernel<D, BN>;
  static const cudaError_t attr = rt::allow_smem(kernel, L::bytes);
  if (attr != cudaSuccess) return attr;
  DqParams p;
  const cudaError_t err = make_maps(a, batch, D, BN, &p.q, &p.k, &p.v, &p.dout);
  if (err != cudaSuccess) return err;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = static_cast<bf16*>(a.g0);
  p.seq = a.seq;
  p.heads = a.heads;
  p.causal = a.causal;
  p.scale = a.scale;
  const int rows = L::kWG * 64;
  const dim3 grid(batch * a.heads, (a.seq + rows - 1) / rows);
  kernel<<<grid, L::kThreads, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, int batch, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    if constexpr (D == 32) {
      static const cudaError_t attr =
          rt::allow_smem(flash_dq_mma_kernel<D>, mma_smem_bytes<D>());
      return launch(flash_dq_mma_kernel<D>, mma_smem_bytes<D>(), attr, a, batch, s);
    } else {
      // k/v tiles of 128 keys for D = 64 (as K1's), 64 for D = 128, where
      // dq, s and dp of 128 keys would not fit the consumers' registers
      return launch_dq_bf16<D, D == 64 ? 128 : 64>(a, batch, s);
    }
  }
  static const cudaError_t attr =
      rt::allow_smem(flash_dq_f32_kernel<D>, dq_f32_smem_bytes<D>());
  return launch(flash_dq_f32_kernel<D>, dq_f32_smem_bytes<D>(), attr, a, batch, s);
}

// K3 in bf16: the tensor maps are encoded here, on every call, and
// passed by value
template <int D>
cudaError_t launch_dkv_bf16(const Args& a, int batch, cudaStream_t stream) {
  using L = DkvLayout<D>;
  static const cudaError_t attr = rt::allow_smem(flash_dkv_bf16_kernel<D>, L::bytes);
  if (attr != cudaSuccess) return attr;
  DkvParams p;
  const cudaError_t err = make_maps(a, batch, D, 64, &p.q, &p.k, &p.v, &p.dout);
  if (err != cudaSuccess) return err;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dk = static_cast<bf16*>(a.g0);
  p.dv = static_cast<bf16*>(a.g1);
  p.seq = a.seq;
  p.heads = a.heads;
  p.causal = a.causal;
  p.scale = a.scale;
  const int keys = L::kWG * 64;
  const dim3 grid(batch * a.heads, (a.seq + keys - 1) / keys);
  flash_dkv_bf16_kernel<D><<<grid, L::kThreads, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, int batch, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    if constexpr (D == 32) {
      static const cudaError_t attr =
          rt::allow_smem(flash_dkv_mma_kernel<D>, mma_smem_bytes<D>());
      return launch(flash_dkv_mma_kernel<D>, mma_smem_bytes<D>(), attr, a, batch, s);
    } else {
      return launch_dkv_bf16<D>(a, batch, s);
    }
  }
  static const cudaError_t attr =
      rt::allow_smem(flash_dkv_f32_kernel<D>, dkv_f32_smem_bytes<D>());
  return launch(flash_dkv_f32_kernel<D>, dkv_f32_smem_bytes<D>(), attr, a, batch, s);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* g0, void* g1, int seq,
               int heads, const long long* st, float scale, int causal) {
  return Args{q, k, v, dout,
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              g0, g1, seq, heads,
              st[0], st[1], st[2], st[3], st[4], st[5],
              st[6], st[7], st[8], st[9], st[10], st[11],
              scale, causal};
}

}  // namespace

// q, k, v, dout: (B, T, H, D) with the strides given (in elements) for
// the batch, time and head axes, in that order for q, k, v, dout; D
// contiguous (bf16: pointers 16-byte aligned and strides multiples of 8
// elements, the TMA rules both bf16 kernels need); D in {32, 64, 128}. lse, delta: (B, H, T)
// f32 contiguous. Outputs (B, T, H, D) contiguous, in the input type.
// is_bf16 != 0 selects __nv_bfloat16, else float. Each returns the CUDA
// error code of its launch (0 on success).
extern "C" int rt_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta,
                           void* dq, int batch, int seq, int heads, int head_dim,
                           const long long* strides, float scale, int causal,
                           int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, seq, heads,
                           strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_dq<32>(a, batch, is_bf16, s);
  if (head_dim == 64) return launch_dq<64>(a, batch, is_bf16, s);
  if (head_dim == 128) return launch_dq<128>(a, batch, is_bf16, s);
  return cudaErrorInvalidValue;
}

extern "C" int rt_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dk, void* dv, int batch, int seq, int heads,
                            int head_dim, const long long* strides, float scale,
                            int causal, int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, seq, heads, strides,
                           scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_dkv<32>(a, batch, is_bf16, s);
  if (head_dim == 64) return launch_dkv<64>(a, batch, is_bf16, s);
  if (head_dim == 128) return launch_dkv<128>(a, batch, is_bf16, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rt_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
