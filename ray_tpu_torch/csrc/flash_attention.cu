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
// What bounds it: at GPT-2-small prefill and training (T <= 1024,
// D = 64) the work is ~2 * T^2 * D flops per head against 4 * T * D
// elements moved, far above the card's ops-per-byte line, so it is bound
// by operations and belongs on the tensor cores at their full rate,
// which on Hopper only the warpgroup product (wgmma) reaches. The bf16
// design:
//  - one block per (b * h, block of 64 or 128 q rows), the blocks with
//    the longest causal rows first; one consumer warpgroup per 64 q
//    rows and one producer warpgroup, which gives its registers to the
//    consumers (setmaxnreg); two consumer warpgroups take turns on the
//    tensor cores through named barriers (ping-pong);
//  - one producer thread loads q once and streams the k/v tiles of BN
//    keys through a ring of stages in shared memory with TMA (4-D
//    tensor maps over (D, H, T, B) built from the tensors' own strides,
//    so the column slices of the fused qkv projection go in without a
//    copy; rows past T arrive as zeros), each stage guarded by a full
//    and an empty mbarrier, so loads overlap the products;
//  - s = q k^T is wgmma with q and k K-major in shared memory; p,
//    rounded to bf16 in registers (the TPU kernel also casts p to v's
//    type), is the register A operand of o += p v, with v the MN-major
//    B operand; p never touches shared memory;
//  - the softmax keeps the row max of the raw logits and takes
//    p = exp2((s - m) scale log2(e)) as one FFMA and one exp2 (the scale
//    must be positive), masking only the tiles that cross the diagonal
//    or the ragged edge (T not a multiple of the tile), so any T works;
//  - within a warpgroup the softmax of tile j runs while the tensor
//    cores run p_{j-1} v_{j-1} (three k/v stages for D = 64);
//  - f32 keeps the first design: the same tiling as scalar f32 FMAs from
//    shared memory (TF32 tensor cores would lose the f32 result's
//    digits), four warps of 16 q rows, synchronous loads;
//  - bf16 at D = 32 (a 64-byte row, below the 128-byte swizzle the TMA
//    and wgmma layouts here assume) runs the first bf16 design,
//    mma.sync m16n8k16 from padded shared tiles (flash_fwd_mma_kernel).
// What holds it back at B=8 T=1024 causal (PERF.md): a block of 64 or
// 128 causal rows runs only 1-8 k/v tiles, so its prologue (q's load,
// the first q k^T alone) and epilogue weigh; persistent blocks that
// prefetch the next tile's q are the next step.

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

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

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the bf16 kernel, from a 1024-byte aligned base: one
// 64-row q tile per consumer warpgroup, kStages k and v tiles of BN
// rows, then the barriers q_full, q_empty, full[kStages],
// empty[kStages].
template <int D, int NWG, int BN>
struct FwdLayout {
  // three stages let tile j + 1 load while tile j - 1 is still read by
  // p v; D = 128 keeps two, so that two blocks fit an SM
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQ = hop::tile_bytes<D>(64);
  static constexpr int kKV = hop::tile_bytes<D>(BN);
  static constexpr int k_off = NWG * kQ;
  static constexpr int v_off = k_off + kStages * kKV;
  static constexpr int bar_off = v_off + kStages * kKV;
  static constexpr int bytes = bar_off + 8 * (2 + 2 * kStages) + 1024;  // + alignment
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int kBlocksPerSM = NWG == 1 ? 2 : 1;
  // the producer warpgroup gives up the registers the consumers take:
  // (NWG + 1) * 128 threads launch with 65536 / threads (/ 2 blocks per
  // SM for NWG = 1) registers each, 128 * 40 + NWG * 128 * kConsumerRegs
  // of them in all
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = NWG == 1 ? 216 : 232;
};

struct FwdParams {
  CUtensorMap q, k, v;  // (B, T, H, D) maps, boxes of 64 (q) and BN (k, v) rows
  bf16* o;              // (B, T, H, D) contiguous
  float* lse;           // (B, H, T)
  int seq, heads, causal;
  int n_bh, n_qb;       // B * H and q blocks of 64 NWG rows: n_bh * n_qb items
  float scale_log2;     // softmax scale times log2(e)
};

// One tile of the online softmax, in place: the raw logits s
// (accumulator layout, element i at row rows[(i >> 1) & 1] and key
// k0 + 8 (i / 4) + 2 tig + (i & 1)) become p = exp2((s - m) c), with
// c = scale log2(e) > 0 and m the new row max of the raw logits, one
// FFMA and one exp2 an element; returns in alpha the factor that
// rescales what was summed against the old max. Only a tile that
// crosses the diagonal or the ragged edge is masked. l stays a per-lane
// partial sum.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int k0,
                                             const int (&rows)[2], int tig,
                                             const FwdParams& p) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
      const bool ok = key < p.seq && (!p.causal || key <= rows[(i >> 1) & 1]);
      sc[i] = ok ? sc[i] : rt::kMaskValue;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(rt::kFullMask, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(rt::kFullMask, mx[r], 2));
    alpha[r] = exp2f((m[r] - mx[r]) * p.scale_log2);
    m[r] = mx[r];
    mc[r] = mx[r] * p.scale_log2;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = exp2f(fmaf(sc[i], p.scale_log2, -mc[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];
  }
}

// p rounded to bf16 (the TPU kernel casts p to v's type) as the register
// A operand of p v: two accumulator column blocks per k16 step
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = rt::pack_f32(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = rt::pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = rt::pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = rt::pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D, int NWG, int BN>
__global__ void __launch_bounds__(FwdLayout<D, NWG, BN>::kThreads,
                                  FwdLayout<D, NWG, BN>::kBlocksPerSM)
flash_fwd_bf16_kernel(const __grid_constant__ FwdParams p) {
  using L = FwdLayout<D, NWG, BN>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char ring[];
  const uint32_t base = (hop::smem_addr(ring) + 1023) & ~1023u;
  const uint32_t q_full = base + L::bar_off, q_empty = q_full + 8;
  const auto full = [&](int s) { return q_full + 8 * (2 + s); };
  const auto empty = [&](int s) { return q_full + 8 * (2 + S + s); };

  // Persistent blocks: the G blocks walk the work items of (q block,
  // b * h), the q blocks with the longest causal rows first, so that one
  // item's q and first k/v tiles load while the last one ends. Round r
  // gives block c item r G + c, or r G + G - 1 - c in odd rounds, so
  // that every block's sum of causal row lengths comes out even.
  const int seq = p.seq, n_items = p.n_bh * p.n_qb;
  const auto item_of = [&](int r) {
    const int G = gridDim.x, c = blockIdx.x;
    return r * G + ((r & 1) ? G - 1 - c : c);
  };
  const auto item = [&](int i, int& q0, int& b, int& h, int& n_k) {
    q0 = (p.n_qb - 1 - i / p.n_bh) * NWG * 64;
    const int bh = i % p.n_bh;
    b = bh / p.heads;
    h = bh % p.heads;
    n_k = p.causal ? (min(q0 + NWG * 64, seq) - 1) / BN + 1 : (seq + BN - 1) / BN;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    hop::mbar_init(q_empty, NWG * 128);
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(full(s), 1);
      hop::mbar_init(empty(s), NWG * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: one thread loads each item's q and keeps the ring of k/v
    // tiles full, across items
    hop::regs_dec<L::kProducerRegs>();
    if (threadIdx.x == NWG * 128) {
      hop::prefetch_map(&p.k);
      hop::prefetch_map(&p.v);
      int t = 0;  // k/v tiles loaded so far
      for (int it = 0, i = item_of(0); i < n_items; i = item_of(++it)) {
        int q0, b, h, n_k;
        item(i, q0, b, h, n_k);
        hop::mbar_wait(q_empty, (it & 1) ^ 1);
        hop::mbar_arrive_expect_tx(q_full, NWG * L::kQ);
        for (int w = 0; w < NWG; ++w)
          hop::tma_tile<D>(base + w * L::kQ, &p.q, q_full, 64, h, q0 + 64 * w, b);
        for (int j = 0; j < n_k; ++j, ++t) {
          const int s = t % S;
          hop::mbar_wait(empty(s), ((t / S) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(full(s), 2 * L::kKV);
          hop::tma_tile<D>(base + L::k_off + s * L::kKV, &p.k, full(s), BN, h, j * BN, b);
          hop::tma_tile<D>(base + L::v_off + s * L::kKV, &p.v, full(s), BN, h, j * BN, b);
        }
      }
    }
  } else {
    hop::regs_inc<L::kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int grp = lane / 4, tig = lane % 4;
    // Two warpgroups take turns on the tensor cores (ping-pong: one
    // issues its products while the other runs its softmax).
    const auto turn_wait = [&] {
      if (NWG == 2) hop::bar_sync(1 + wg, 256);
    };
    const auto turn_pass = [&] {
      if (NWG == 2) hop::bar_arrive(2 - wg, 256);
    };
    if (NWG == 2 && wg == 1) turn_pass();  // warpgroup 0 goes first
    const uint32_t q_tile = base + wg * L::kQ;

    // s = q k^T (64 x BN; q and k K-major in shared memory) into sc, from
    // the ring's tile t
    const auto issue_s = [&](float (&sc)[BN / 2], int t) {
      const uint32_t k_tile = base + L::k_off + (t % S) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss<0>(sc, hop::desc_k(q_tile, 64, kk), hop::desc_k(k_tile, BN, kk), kk);
      hop::wgmma_commit();
    };
    // o += p v, with p the register A operand and v MN-major
    const auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4], int t) {
      const uint32_t v_tile = base + L::v_off + (t % S) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hop::wgmma_rs<1>(o, pa[kk], hop::desc_mn(v_tile, BN, kk), 1);
      hop::wgmma_commit();
    };

    int t0 = 0;  // the ring's tile of this item's first k/v tile
    for (int it = 0, i = item_of(0); i < n_items; i = item_of(++it)) {
      int q0, b, h, n_k;
      item(i, q0, b, h, n_k);
      // this warpgroup's rows qw .. qw + 63 run every k/v tile of the
      // item (with two warpgroups in ping-pong, the first may run one
      // tile past its diagonal, fully masked, and the second rows past T)
      const int qw = q0 + 64 * wg;
      const int rows[2] = {qw + 16 * warp + grp, qw + 16 * warp + grp + 8};
      const auto edge = [&](int j) {
        return (p.causal && j * BN + BN - 1 > qw) || j * BN + BN > seq;
      };
      float o[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
      hop::mbar_wait(q_full, it & 1);

      // Software pipeline within the warpgroup: while p_{j-1} v_{j-1}
      // runs on the tensor cores, the softmax of tile j runs beside it.
      uint32_t pa[BN / 16][4];
      float alpha[2];
      {
        float sc[BN / 2];
        hop::mbar_wait(full(t0 % S), (t0 / S) & 1);
        turn_wait();
        hop::wgmma_fence();
        issue_s(sc, t0);
        turn_pass();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        softmax_tile<BN>(sc, m, l, alpha, edge(0), 0, rows, tig, p);
        pack_p<BN>(pa, sc);
      }
      for (int j = 1; j < n_k; ++j) {
        const int t = t0 + j;
        float sc[BN / 2];
        hop::mbar_wait(full(t % S), (t / S) & 1);
        hop::fence_regs(o);
        turn_wait();
        hop::wgmma_fence();
        issue_s(sc, t);
        hop::wgmma_fence();
        issue_pv(o, pa, t - 1);
        turn_pass();
        hop::wgmma_wait<1>();  // s_j is in; p_{j-1} v_{j-1} may still run
        hop::fence_regs(sc);
        softmax_tile<BN>(sc, m, l, alpha, edge(j), j * BN, rows, tig, p);
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
        hop::fence_frag(pa);
        hop::mbar_arrive(empty((t - 1) % S));
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        // packed only now: written while p v runs, the next A fragment
        // would make ptxas serialize the products (C7513)
        pack_p<BN>(pa, sc);
      }
      // every q k^T of the item is done: the next item's q may load
      hop::mbar_arrive(q_empty);
      {
        const int t = t0 + n_k - 1;
        hop::fence_regs(o);
        hop::wgmma_fence();
        issue_pv(o, pa, t);
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
        hop::fence_frag(pa);
        hop::mbar_arrive(empty(t % S));
      }
      t0 += n_k;

      // emit o and lse = m scale + log l (natural log); a row with
      // l == 0 divides by 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(rt::kFullMask, l[r], 1);
        l[r] += __shfl_xor_sync(rt::kFullMask, l[r], 2);
        if (rows[r] >= seq) continue;
        const float ls = l[r] == 0.f ? 1.f : l[r];
        bf16* orow = p.o + ((static_cast<long long>(b) * seq + rows[r]) * p.heads + h) * D + 2 * tig;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
              rt::pack_f32(o[4 * jj + 2 * r] / ls, o[4 * jj + 2 * r + 1] / ls);
        if (tig == 0)
          p.lse[(static_cast<long long>(b) * p.heads + h) * seq + rows[r]] =
              m[r] * p.scale_log2 * kLn2 + logf(ls);
      }
    }
  }
}

// --------------------------------------------- bf16 at head dim 32

// A 32-column bf16 row is 64 bytes, half the 128-byte swizzle span that
// the TMA boxes and wgmma descriptors of the kernel above are built on.
// At D = 32 (the tiny presets, test-sized) the bf16 forward is the
// warp-level design instead: one block per (b * h, 64-row q tile), four
// warps of 16 q rows, mma.sync m16n8k16 with f32 accumulate, q kept as
// A fragments, each 64-key k/v tile staged in shared memory with rows
// padded by 8 elements, p rounded to bf16 in registers as the A operand
// of p v. Loads are synchronous: at D = 32 a tile is 4 KB.

template <int D>
constexpr int mma_smem_bytes() {  // q, k, v tiles, rows padded by 8
  return 3 * kBlockQ * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// one 64-row tile of q, k or v into shared memory
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      int t0, int seq, int tid) {
  rt::stage_bf16<D, kBlockQ, kWarps * 32>(dst, src, rs, t0, seq, tid);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
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

  stage_tile<D>(qs, q + b * st.qb + h * st.qh, st.qt, q0, seq, tid);
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
    stage_tile<D>(ks, k + b * st.kb + h * st.kh, st.kt, k0, seq, tid);
    stage_tile<D>(vs, v + b * st.vb + h * st.vh, st.vt, k0, seq, tid);
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
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                       int batch, int seq, int heads, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  static const cudaError_t attr =
      rt::allow_smem(flash_fwd_mma_kernel<D>, mma_smem_bytes<D>());
  if (attr != cudaSuccess) return attr;
  return launch<decltype(&flash_fwd_mma_kernel<D>), __nv_bfloat16>(
      flash_fwd_mma_kernel<D>, mma_smem_bytes<D>(), q, k, v, o, lse, batch, seq, heads, st,
      scale, causal, stream);
}

int sm_count();

// The bf16 kernel with NWG consumer warpgroups (64 NWG q rows a block)
// and k/v tiles of BN keys; the tensor maps are encoded here, on every
// call, and passed by value.
template <int D, int NWG, int BN>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch, int seq, int heads, const Strides& st, float scale,
                        int causal, cudaStream_t stream) {
  using L = FwdLayout<D, NWG, BN>;
  static const cudaError_t attr = rt::allow_smem(flash_fwd_bf16_kernel<D, NWG, BN>, L::bytes);
  if (attr != cudaSuccess) return attr;
  FwdParams p;
  cudaError_t err = hop::make_map(&p.q, q, batch, seq, heads, D, st.qb, st.qt, st.qh, 64);
  if (err == cudaSuccess)
    err = hop::make_map(&p.k, k, batch, seq, heads, D, st.kb, st.kt, st.kh, BN);
  if (err == cudaSuccess)
    err = hop::make_map(&p.v, v, batch, seq, heads, D, st.vb, st.vt, st.vh, BN);
  if (err != cudaSuccess) return err;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.seq = seq;
  p.heads = heads;
  p.causal = causal;
  p.n_bh = batch * heads;
  p.n_qb = (seq + NWG * 64 - 1) / (NWG * 64);
  p.scale_log2 = scale * kLog2e;
  const long long items = static_cast<long long>(p.n_bh) * p.n_qb;
  const int grid = static_cast<int>(std::min<long long>(items, L::kBlocksPerSM * sm_count()));
  flash_fwd_bf16_kernel<D, NWG, BN><<<grid, L::kThreads, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// 128 q rows a block (two warpgroups in ping-pong) halve the k/v
// traffic a q row costs, but leave SMs idle when the grid is small: on
// the H100, 64 rows are faster at B=1 T=1024 (96 items of 128 rows for
// 132 SMs), and 128 rows within 2 % of 64, or faster, from two items
// per SM on (chip_smoke.py prints both as "ms_by_block_rows", at the
// main shapes and at its BLOCK_ROWS_SHAPES). So take 128 rows from two
// items per SM on.
int default_block_rows(int batch, int seq, int heads) {
  const long long blocks128 = static_cast<long long>(batch) * heads * ((seq + 127) / 128);
  return blocks128 >= 2LL * sm_count() ? 128 : 64;
}

}  // namespace

// q, k, v: (B, T, H, D) with the strides given (in elements) for the
// batch, time and head axes, D contiguous (bf16: pointers 16-byte
// aligned, strides multiples of 8 elements, the TMA rules); o: (B, T,
// H, D) contiguous; lse: (B, H, T) f32; D in {32, 64, 128}. bf16 != 0
// selects __nv_bfloat16, else float. block_rows picks 64 or 128 q rows a
// block for the bf16 wgmma kernel at D = 64, 128 (0: by the grid's size;
// ignored at D = 32). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int rt_flash_fwd_rows(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int seq, int heads, int head_dim,
                                 long long sqb, long long sqt, long long sqh,
                                 long long skb, long long skt, long long skh,
                                 long long svb, long long svt, long long svh,
                                 float scale, int causal, int bf16, void* stream,
                                 int block_rows) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 32 && head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  if (!bf16) {
    if (head_dim == 32)
      return launch_f32<32>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
    return head_dim == 64
               ? launch_f32<64>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s)
               : launch_f32<128>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
  }
  // block_rows is the wgmma kernel's choice; the D = 32 kernel has one
  // height, 64
  if (head_dim == 32)
    return launch_mma<32>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
  if (block_rows == 0) block_rows = default_block_rows(batch, seq, heads);
  if (block_rows != 64 && block_rows != 128) return cudaErrorInvalidValue;
  const bool two = block_rows == 128;
  if (head_dim == 64)
    return two ? launch_bf16<64, 2, 128>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s)
               : launch_bf16<64, 1, 128>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
  return two ? launch_bf16<128, 2, 64>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s)
             : launch_bf16<128, 1, 64>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
}

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int batch, int seq, int heads, int head_dim,
                            long long sqb, long long sqt, long long sqh, long long skb,
                            long long skt, long long skh, long long svb, long long svt,
                            long long svh, float scale, int causal, int bf16,
                            void* stream) {
  return rt_flash_fwd_rows(q, k, v, o, lse, batch, seq, heads, head_dim, sqb, sqt, sqh,
                           skb, skt, skh, svb, svt, svh, scale, causal, bf16, stream, 0);
}

extern "C" const char* rt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
