// RG-LRU first-order linear recurrence for Hopper (sm_90a), f32:
// h_t = a_t * h_{t-1} + x_t over [B, S, D], from h0 (zeros when null).
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py:rglru_scan_pallas
// (body _rglru_kernel). The Pallas grid (B, D/blk_d, S/chunk) with its
// VMEM state row is not carried over: here one thread owns one (b, d)
// channel, keeps h in a register and walks t = 0..S-1. Neighbouring
// threads own neighbouring d, so every step's loads of a and x and its
// store of h are coalesced; any S and D work, ragged edges masked by the
// channel count, with no chunking.
//
// Bound on the H100: bytes. a and x are read once and hs written once
// (12 bytes per element) plus h0/h_last; at the main path's shape
// (B 40, S 64, D 2560) about 79 MB, at least 23.6 us at 3.35 TB/s. The
// two FLOP per element are negligible, so the design is about keeping
// loads in flight: the source reads kUnroll steps of a and x (which do
// not depend on h) before their multiply-adds. ptxas keeps the kernel at
// 32 registers at any unroll, so not all of those loads are in flight at
// once; batching them is a later optimisation.
//
// Each step is __fadd_rn(__fmul_rn(a, h), x): no FMA contraction, the
// rounding of the plain version's multiply then add, so the two agree
// bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
             const float* __restrict__ h0, float* __restrict__ hs,
             float* __restrict__ h_last, int64_t channels, int64_t s,
             int64_t d) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int64_t bi = c / d;
  const int64_t di = c - bi * d;
  const int64_t base = bi * s * d + di;      // element (bi, 0, di)
  float h = h0 != nullptr ? h0[c] : 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll];
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + (t + u) * d;
      av[u] = a[e];
      xv[u] = x[e];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      hs[base + (t + u) * d] = h;
    }
  }
  for (; t < s; ++t) {
    const int64_t e = base + t * d;
    h = __fadd_rn(__fmul_rn(a[e], h), x[e]);
    hs[e] = h;
  }
  h_last[c] = h;
}

}  // namespace

// a, x, hs [b, s, d]; h0 (may be null), h_last [b, d]; all contiguous f32.
// Returns a cudaError_t.
extern "C" int rglru_scan_f32(const float* a, const float* x, const float* h0,
                              float* hs, float* h_last, long long b,
                              long long s, long long d, void* stream) {
  if (b <= 0 || d <= 0) return 0;
  if (s < 0) return cudaErrorInvalidValue;
  const int64_t channels = static_cast<int64_t>(b) * d;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  rglru_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, x, h0, hs, h_last,
                                                      channels, s, d);
  return static_cast<int>(cudaGetLastError());
}
