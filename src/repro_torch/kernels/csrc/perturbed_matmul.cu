// Fused perturbed matmul for Hopper (sm_90a): out = x @ (w + eps * z(seed)).
//
// Replaces the TPU kernel repro/kernels/perturbed_matmul.py:
// perturbed_matmul_pallas (body _pmm_kernel). Element (k, n) of w draws the
// counter off + k * N + n (uint32, wrapping) over the UNPADDED w, from the
// counter-hash stream of counter_hash.cuh: the perturbed weights never
// exist in device memory, only one (BK x BN) tile of them in shared memory.
//
// Shapes: x [M, K] and w [K, N], row-major f32; out [M, N] f32. The main
// path (full OPT-125M, 5 clients x 8 rows x 64 tokens) has M = 2560 and
// (K, N) in {(768, 768), (768, 3072), (3072, 768)}.
//
// Bound on the H100: f32 operations. 2*M*K*N flops (12.1 GFLOP at
// 2560 x 768 x 3072) need at least 0.18 ms at 67 TFLOP/s, while the bytes
// (x, w and out once each, 17 MB there) need 5 us. Design: plain f32 FMA on
// the CUDA cores -- no TF32 and no tensor cores, for parity with cuBLAS
// SGEMM and with the plain version. Each block owns a BM x BN = 128 x 128
// output tile and loops over K in steps of BK = 16 (the loop replaces the
// TPU grid's sequential k axis): per step it stages the x tile (transposed)
// and the w tile in shared memory, turns the w tile into w + eps*z on the
// way, and each of its 256 threads accumulates an 8 x 8 register
// micro-tile; the next step's global loads are issued before the product,
// so their latency hides behind it, and registers are capped at 128 so two
// blocks share an SM (one block's draws overlap the other's FMAs).
// z is regenerated once per M-tile for each w tile: M / BM = 20 times per
// weight at M = 2560, about 8 Box-Muller draws per thread for every 1024
// FMAs. Ragged M/K/N edges are masked in the kernel; x's columns past K
// are zero, so they add nothing. w + eps*z is formed with __fmul_rn /
// __fadd_rn, so an identity x returns exactly what seeded_axpy writes for
// the same leaf. Later work: wgmma tiles with a parity tolerance, TMA, and
// a dual-eps variant that draws z once for both rollouts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int LDA = BM + 4;   // padded rows: fewer bank conflicts, 16B rows
constexpr int LDW = BN + 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 2)
pmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, int M, int K, int N, uint32_t seed_mix,
           uint32_t off, const float* __restrict__ eps_ptr, int x_vec,
           int out_vec) {
  __shared__ __align__(16) float xs[BK][LDA];   // x tile, xs[k][m]
  __shared__ __align__(16) float ws[BK][LDW];   // (w + eps z) tile, ws[k][n]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float eps = *eps_ptr;

  // x tile: 128 rows x 16 columns = 512 groups of 4, two per thread;
  // four neighbouring threads read one row's 64 contiguous bytes.
  // w tile: 16 rows x 128 columns, eight per thread; a warp reads 128
  // contiguous bytes of one row.
  const int xr0 = tid / 4;                  // rows xr0 and xr0 + 64
  const int xc = (tid % 4) * 4;
  const int wr0 = tid / BN;                 // rows wr0 + 2 * it
  const int wc = tid % BN;
  float xv[2][4];
  float wv[8];

  // global -> registers for the tile at k0 (zero past the edges)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int gm = m0 + xr0 + it * 64;
      const int gk = k0 + xc;
      if (x_vec && gm < M && gk + 4 <= K) {
        const float4 q = *reinterpret_cast<const float4*>(
            x + static_cast<int64_t>(gm) * K + gk);
        xv[it][0] = q.x; xv[it][1] = q.y; xv[it][2] = q.z; xv[it][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[it][e] = (gm < M && gk + e < K)
                          ? x[static_cast<int64_t>(gm) * K + gk + e] : 0.0f;
      }
    }
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int gk = k0 + wr0 + it * (kThreads / BN);
      const int gn = n0 + wc;
      wv[it] = (gk < K && gn < N) ? w[static_cast<int64_t>(gk) * N + gn]
                                  : 0.0f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // registers -> shared memory, perturbing the w tile on the way
#pragma unroll
    for (int it = 0; it < 2; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[xc + e][xr0 + it * 64] = xv[it][e];
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = wr0 + it * (kThreads / BN);
      const int gk = k0 + r;
      const int gn = n0 + wc;
      float v = 0.0f;
      if (gk < K && gn < N) {
        const uint32_t ctr = off + static_cast<uint32_t>(gk) *
                                       static_cast<uint32_t>(N) +
                             static_cast<uint32_t>(gn);
        v = counter_hash::axpy(wv[it], eps, ctr, seed_mix);
      }
      ws[r][wc] = v;
    }
    __syncthreads();
    // the next tile's loads are in flight while this tile is multiplied
    if (k0 + BK < K) fetch(k0 + BK);

    // rows {ty*4 + i, 64 + ty*4 + i}, columns {tx*4 + j, 64 + tx*4 + j}
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
    float* row = out + static_cast<int64_t>(gm) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      if (out_vec && gn + 4 <= N) {
        *reinterpret_cast<float4*>(row + gn) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < N) row[gn + e] = acc[i][h * 4 + e];
      }
    }
  }
}

}  // namespace

extern "C" int perturbed_matmul_f32(const float* x, const float* w,
                                    float* out, int m, int k, int n,
                                    unsigned int seed, unsigned int off,
                                    const float* eps, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  // float4 paths need 16-byte aligned rows: a base aligned to 16 bytes and
  // a row length that is a multiple of 4
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (k % 4 == 0);
  const int out_vec =
      (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (n % 4 == 0);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  pmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, m, k, n, seed * counter_hash::kGolden, off, eps, x_vec,
      out_vec);
  return static_cast<int>(cudaGetLastError());
}
