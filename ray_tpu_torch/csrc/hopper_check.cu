// A check of the Hopper building blocks in hopper.cuh, one product at a
// time, for chip_smoke.py to hold against torch.matmul on the card
// before it runs the kernels that join them (K1, K3):
//   form 0: c = a b^T, a (64, K) and b (N, K) row-major, both loaded by
//           TMA with the 128-byte swizzle and read K-major by wgmma from
//           shared memory (K1's q k^T, K3's k q^T and v do^T);
//   form 1: c = a b, a (64, 64) row-major taken into registers as the
//           A fragment, b (64, N) row-major loaded by TMA and read
//           MN-major (K1's p v, K3's p^T do and ds^T q).
// N and K are 64 or 128 (form 1: K = 64); c is (64, N) f32 row-major.
// One block of one warpgroup; not on any model path.

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct CheckParams {
  CUtensorMap a, b;
  const __nv_bfloat16* a_ptr;  // form 1: a read straight into registers
  float* c;
};

template <int FORM, int N, int K>
__global__ void __launch_bounds__(128) hopper_check_kernel(const __grid_constant__ CheckParams p) {
  constexpr int kA = hop::tile_bytes<K>(64);
  extern __shared__ __align__(1024) unsigned char ring[];
  const uint32_t base = (hop::smem_addr(ring) + 1023) & ~1023u;
  const uint32_t a_tile = base, b_tile = base + kA;
  const uint32_t bar = b_tile + N * K * 2;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, grp = lane / 4, tig = lane % 4;
  if (t == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    if (FORM == 0) {
      hop::mbar_arrive_expect_tx(bar, kA + N * K * 2);
      hop::tma_tile<K>(a_tile, &p.a, bar, 64, 0, 0, 0);
      hop::tma_tile<K>(b_tile, &p.b, bar, N, 0, 0, 0);
    } else {
      hop::mbar_arrive_expect_tx(bar, N * K * 2);
      hop::tma_tile<N>(b_tile, &p.b, bar, K, 0, 0, 0);
    }
  }
  const int r0 = 16 * warp + grp;
  uint32_t af[K / 16][4];
  if (FORM == 1) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const __nv_bfloat16* lo = p.a_ptr + r0 * K + 16 * kk + 2 * tig;
      af[kk][0] = rt::ld32(lo);
      af[kk][1] = rt::ld32(lo + 8 * K);
      af[kk][2] = rt::ld32(lo + 8);
      af[kk][3] = rt::ld32(lo + 8 * K + 8);
    }
  }
  hop::mbar_wait(bar, 0);
  float d[N / 2];
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if (FORM == 0)
      hop::wgmma_ss<0>(d, hop::desc_k(a_tile, 64, kk), hop::desc_k(b_tile, N, kk), kk);
    else
      hop::wgmma_rs<1>(d, af[kk], hop::desc_mn(b_tile, K, kk), kk);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(d);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    p.c[(r0 + 8 * ((i >> 1) & 1)) * N + 8 * (i / 4) + 2 * tig + (i & 1)] = d[i];
}

template <int FORM, int N, int K>
cudaError_t run(const void* a, const void* b, float* c, cudaStream_t stream) {
  constexpr int bytes = hop::tile_bytes<K>(64) + N * K * 2 + 8 + 1024;
  static const cudaError_t attr = rt::allow_smem(hopper_check_kernel<FORM, N, K>, bytes);
  if (attr != cudaSuccess) return attr;
  CheckParams p;
  // (rows, cols) row-major as a (1, rows, 1, cols) map
  cudaError_t err = hop::make_map(&p.a, a, 1, 64, 1, K, 64 * K, K, K, 64);
  if (err == cudaSuccess)
    err = FORM == 0 ? hop::make_map(&p.b, b, 1, N, 1, K, N * K, K, K, N)
                    : hop::make_map(&p.b, b, 1, K, 1, N, N * K, N, N, K);
  if (err != cudaSuccess) return err;
  p.a_ptr = static_cast<const __nv_bfloat16*>(a);
  p.c = c;
  hopper_check_kernel<FORM, N, K><<<1, 128, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// a, b bf16 and c f32, contiguous on the card, shaped as above. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int rt_hopper_check(const void* a, const void* b, void* c, int form, int n,
                               int k, void* stream) {
  float* out = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0 && n == 64 && k == 64) return run<0, 64, 64>(a, b, out, s);
  if (form == 0 && n == 64 && k == 128) return run<0, 64, 128>(a, b, out, s);
  if (form == 0 && n == 128 && k == 64) return run<0, 128, 64>(a, b, out, s);
  if (form == 0 && n == 128 && k == 128) return run<0, 128, 128>(a, b, out, s);
  if (form == 1 && n == 64 && k == 64) return run<1, 64, 64>(a, b, out, s);
  if (form == 1 && n == 128 && k == 64) return run<1, 128, 64>(a, b, out, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rt_hopper_check_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
