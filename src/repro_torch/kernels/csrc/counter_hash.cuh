// The counter-hash Gaussian stream shared by every kernel that draws z.
//
// z[idx] is Box-Muller of two uniforms, each the top 24 bits of
// fmix32(2*idx + seed*0x9E3779B9) (and of that counter + 1), floored at
// 2^-24 -- the stream repro/kernels/seeded_axpy.py draws on every backend.
// Products and sums use __fmul_rn / __fadd_rn so FMA contraction never
// changes the rounding, and logf/cosf/sqrtf are the precise versions (the
// build never passes --use_fast_math): every kernel that includes this
// header computes the same bits for the same (seed, counter).
#pragma once
#include <stdint.h>

namespace counter_hash {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24

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

// seed_mix is seed * kGolden (mod 2^32), formed once per thread from the
// leaf seed the kernel reads from device memory.
__device__ __forceinline__ float gaussian(uint32_t idx, uint32_t seed_mix) {
  const uint32_t base = idx * 2u + seed_mix;
  const float u1 = bits_to_unit(fmix32(base));
  const float u2 = bits_to_unit(fmix32(base + 1u));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

// w + scale * z(idx), two roundings, as the plain version computes it.
__device__ __forceinline__ float axpy(float w, float scale, uint32_t idx,
                                      uint32_t seed_mix) {
  return __fadd_rn(w, __fmul_rn(scale, gaussian(idx, seed_mix)));
}

}  // namespace counter_hash
