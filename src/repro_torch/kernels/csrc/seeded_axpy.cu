// Seeded Gaussian axpy for Hopper (sm_90a): out = w + scale * z(seed).
//
// Replaces the TPU kernel repro/kernels/seeded_axpy.py:seeded_axpy_pallas
// (body _axpy_kernel). z[idx] is Box-Muller of two uniforms, each the top
// 24 bits of fmix32(2*idx + seed*0x9E3779B9) (and of that counter + 1),
// floored at 2^-24. The counter is the element's flat index in the leaf as
// uint32 with natural wraparound, exactly as the TPU kernel computes it.
//
// Bound on the H100: bytes. Each element is read once and written once
// (8 bytes in f32); z lives only in registers. The hash and Box-Muller cost
// about a dozen f32 operations per element, far below the card's f32 rate
// at this byte count. Design: 4 consecutive elements per thread with float4
// loads and stores where the leaf is 16-byte aligned; `out` may alias `w`
// (the in-place chained MeZO walk). The scale is read from device memory so
// the update needs no host round trip. Products and sums use __fmul_rn /
// __fadd_rn so no FMA contraction changes the rounding relative to the
// plain version (w + scale * z, two roundings); logf/cosf/sqrtf are the
// precise versions (the build never passes --use_fast_math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24
constexpr int kItems = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  const float f = __fmul_rn(static_cast<float>(bits >> 8), kInv24);
  return fmaxf(f, kInv24);
}

__device__ __forceinline__ float gaussian(uint32_t idx, uint32_t seed_mix) {
  const uint32_t base = idx * 2u + seed_mix;
  const float u1 = bits_to_unit(fmix32(base));
  const float u2 = bits_to_unit(fmix32(base + 1u));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

__device__ __forceinline__ float axpy(float w, float scale, uint32_t idx,
                                      uint32_t seed_mix) {
  return __fadd_rn(w, __fmul_rn(scale, gaussian(idx, seed_mix)));
}

__global__ void __launch_bounds__(kThreads)
axpy_kernel(const float* w, float* out, int64_t n, uint32_t seed_mix,
            const float* __restrict__ scale_ptr, int vec) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kItems;
  if (i0 >= n) return;
  const float scale = *scale_ptr;
  if (vec && i0 + kItems <= n) {
    float4 v = *reinterpret_cast<const float4*>(w + i0);
    const uint32_t c = static_cast<uint32_t>(i0);
    v.x = axpy(v.x, scale, c, seed_mix);
    v.y = axpy(v.y, scale, c + 1u, seed_mix);
    v.z = axpy(v.z, scale, c + 2u, seed_mix);
    v.w = axpy(v.w, scale, c + 3u, seed_mix);
    *reinterpret_cast<float4*>(out + i0) = v;
  } else {
    for (int k = 0; k < kItems && i0 + k < n; ++k) {
      out[i0 + k] = axpy(w[i0 + k], scale, static_cast<uint32_t>(i0 + k),
                         seed_mix);
    }
  }
}

}  // namespace

extern "C" int seeded_axpy_f32(const float* w, float* out, long long n,
                               unsigned int seed, const float* scale,
                               void* stream) {
  if (n <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t per_block = static_cast<int64_t>(kThreads) * kItems;
  const int64_t blocks = (n + per_block - 1) / per_block;
  axpy_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      w, out, n, seed * kGolden, scale, vec);
  return static_cast<int>(cudaGetLastError());
}
