// Seeded Gaussian axpy for Hopper (sm_90a): out = w + scale * z(seed).
//
// Replaces the TPU kernel repro/kernels/seeded_axpy.py:seeded_axpy_pallas
// (body _axpy_kernel). z is the counter-hash stream of counter_hash.cuh.
// The counter of element i is off + i as uint32 with natural wraparound:
// off is 0 for a whole leaf, and layer * prod(rest) for one layer sliced
// out of a scan-stacked [L, ...] leaf, so a slice draws the very values the
// whole leaf has there (the fused dual forward's `resolve`).
//
// A second entry, seeded_gather_f32, perturbs gathered embedding rows:
// out[r, j] = w[tok[r], j] + scale * z(off + tok[r] * D + j) -- the bits
// row tok[r] has in the whole-table stream, drawn only for the rows the
// batch reads (the fused dual forward's `perturbed_gather`).
//
// Bound on the H100: instruction issue, then bytes. Each element is read
// once and written once (8 bytes in f32); z lives only in registers. But
// each element costs a whole draw -- two fmix32, a precise logf, sqrtf and
// cosf -- about 105 instructions on the shortest SASS path, so a warp
// issues longer than its bytes take to move (chip_smoke.py prints both
// bounds). Design: 4 consecutive elements per thread with float4
// loads and stores where the leaf is 16-byte aligned; `out` may alias `w`
// (the in-place chained MeZO walk). The scale and the leaf's 32-bit stream
// seed are read from device memory, so the update needs no host round trip
// and a captured CUDA graph replays each round with that round's seeds.
//
// bf16 leaves (seeded_axpy_bf16, seeded_gather_bf16), as the TPU kernel
// computes them: w is widened to f32, w + scale * z formed with the same
// two f32 roundings, and the sum rounded once to bf16, to nearest even
// (__float2bfloat16_rn, as XLA's f32 -> bf16 convert). Vector access is 4
// bf16 (8 bytes) where the leaf is 8-byte aligned. A draw costs what it
// costs in f32, so a bf16 pass keeps the f32 pass's issue bound while its
// bytes halve (4 a element).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

using counter_hash::axpy;

constexpr int kItems = 4;
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 consecutive elements: a float4, or 4 bf16 (8 bytes)
template <typename Elem>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  static constexpr int kAlign = 16;
  __device__ static float4 widen(float4 v) { return v; }
  __device__ static float4 narrow(float4 v) { return v; }
};
template <>
struct Vec4<bf16> {
  using type = uint2;
  static constexpr int kAlign = 8;
  __device__ static float4 widen(uint2 u) {
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  __device__ static uint2 narrow(float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(const Elem* w, Elem* out, int64_t n,
            const uint32_t* __restrict__ seed_ptr, uint32_t off,
            const float* __restrict__ scale_ptr, int vec) {
  using V = Vec4<Elem>;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kItems;
  if (i0 >= n) return;
  const float scale = *scale_ptr;
  const uint32_t seed_mix = *seed_ptr * counter_hash::kGolden;
  const uint32_t c = off + static_cast<uint32_t>(i0);
  if (vec && i0 + kItems <= n) {
    float4 v = V::widen(*reinterpret_cast<const typename V::type*>(w + i0));
    v.x = axpy(v.x, scale, c, seed_mix);
    v.y = axpy(v.y, scale, c + 1u, seed_mix);
    v.z = axpy(v.z, scale, c + 2u, seed_mix);
    v.w = axpy(v.w, scale, c + 3u, seed_mix);
    *reinterpret_cast<typename V::type*>(out + i0) = V::narrow(v);
  } else {
    for (int k = 0; k < kItems && i0 + k < n; ++k) {
      out[i0 + k] = from_f32<Elem>(axpy(to_f32(w[i0 + k]), scale,
                                        c + static_cast<uint32_t>(k), seed_mix));
    }
  }
}

// One thread per output element of the [rows, d] gather.
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Elem* __restrict__ w, const int64_t* __restrict__ tok,
              Elem* __restrict__ out, int64_t rows, int64_t d,
              const uint32_t* __restrict__ seed_ptr, uint32_t off,
              const float* __restrict__ scale_ptr) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= rows * d) return;
  const int64_t r = e / d;
  const int64_t j = e - r * d;
  const int64_t src = tok[r] * d + j;
  out[e] = from_f32<Elem>(axpy(to_f32(w[src]), *scale_ptr,
                               off + static_cast<uint32_t>(src),
                               *seed_ptr * counter_hash::kGolden));
}

template <typename Elem>
int launch_axpy(const Elem* w, Elem* out, long long n, const unsigned int* seed,
                unsigned int off, const float* scale, void* stream) {
  if (n <= 0) return 0;
  constexpr int kAlign = Vec4<Elem>::kAlign;
  const int vec = (reinterpret_cast<uintptr_t>(w) % kAlign == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % kAlign == 0);
  const int64_t per_block = static_cast<int64_t>(kThreads) * kItems;
  const int64_t blocks = (n + per_block - 1) / per_block;
  axpy_kernel<Elem><<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      w, out, n, seed, off, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem>
int launch_gather(const Elem* w, const long long* tok, Elem* out,
                  long long rows, long long d, const unsigned int* seed,
                  unsigned int off, const float* scale, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const int64_t blocks = (rows * d + kThreads - 1) / kThreads;
  gather_kernel<Elem><<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      w, reinterpret_cast<const int64_t*>(tok), out, rows, d, seed, off,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seed points to the leaf's stream seed (one uint32 on the device).
extern "C" int seeded_axpy_f32(const float* w, float* out, long long n,
                               const unsigned int* seed, unsigned int off,
                               const float* scale, void* stream) {
  return launch_axpy(w, out, n, seed, off, scale, stream);
}

extern "C" int seeded_gather_f32(const float* w, const long long* tok,
                                 float* out, long long rows, long long d,
                                 const unsigned int* seed, unsigned int off,
                                 const float* scale, void* stream) {
  return launch_gather(w, tok, out, rows, d, seed, off, scale, stream);
}

// The same on bf16 leaves: w and out hold bf16 (out may be w).
extern "C" int seeded_axpy_bf16(const void* w, void* out, long long n,
                                const unsigned int* seed, unsigned int off,
                                const float* scale, void* stream) {
  return launch_axpy(static_cast<const bf16*>(w), static_cast<bf16*>(out), n,
                     seed, off, scale, stream);
}

extern "C" int seeded_gather_bf16(const void* w, const long long* tok,
                                  void* out, long long rows, long long d,
                                  const unsigned int* seed, unsigned int off,
                                  const float* scale, void* stream) {
  return launch_gather(static_cast<const bf16*>(w), tok,
                       static_cast<bf16*>(out), rows, d, seed, off, scale,
                       stream);
}
