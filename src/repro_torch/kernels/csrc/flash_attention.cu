// Flash attention forward for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel): online-softmax attention
// with causal masking, an optional local window, GQA (kv head h / group)
// and q rows that are the last Sq of the Skv positions (sq_offset =
// Skv - Sq). Key tiles that no query row of the block can see are skipped.
//
// Bound on the H100: at the main path's shape ([40,12,64,64], causal) the
// kernel moves 31.5 MB (q, k, v read once, out written once) and does
// about 0.26 GFLOP of useful work, so it is bound by bytes (~9.4 us at
// 3.35 TB/s); the f32 operations need ~4 us at 67 TFLOP/s.
//
// Design at head_dim 16, 32 and 64 (flash_fwd_small_kernel): one block
// per (batch*head, tile of 32 query rows), each query row split over
// kSmallLanes = 4 adjacent lanes of a warp (eight rows per warp, 128
// threads a block); lane k owns the float4 columns k + 4i, so the four
// lanes of a row read 64 contiguous bytes of a shared-memory row at a time
// and the eight rows of a warp read the same words (a broadcast). A score is the
// lane's partial dot reduced over its group with two xor shuffles; every
// lane of the group keeps the same running max m, normalizer l, and its
// quarter of the accumulator, updated per key tile with the rescale
// alpha = exp(m - m_new), exactly the TPU kernel's per-tile update. Key
// and value tiles of 32 rows (16 KB for k and v at D = 64) are copied by
// cp.async into two buffers, so the copy of tile t + 1 runs while tile t
// is scored. Four lanes a row give each SM about four times the warps of a
// thread per row, and each score is a chain of D / 4 dependent FMAs and two
// shuffles instead of D FMAs. Plain f32 FMA and the precise expf, no TF32
// and no tensor cores (wgmma tiles are later work).
//
// Head dim 256 (recurrentgemma-2b: q [40,10,64,256] against one kv head
// [40,1,64,256], causal, window 2048) has its own kernel: four lanes would
// each hold 128 floats of q and accumulator, and double-buffered [32][256]
// key and value tiles are 128 KB, over the 48 KB static limit. flash_fwd_split_kernel
// splits each query row over kLanes = 8 adjacent lanes of a warp (four
// rows per warp, 16 per block: 16 ran faster than 32 or 8 on the H100);
// lane k owns the float4 columns 4k + 32i (i = 0..7), 32 of the 256, so a
// group reads 128 contiguous bytes of a shared-memory row per step and no
// two lanes of a group share a bank. A score is the lane's partial dot
// reduced over its group with three xor shuffles; every lane of the group
// then keeps the same running max and normalizer. Key tiles are 16 rows
// (16 KB each for k and v).
// Bound at that shape: bytes, 57.7 MB of q/k/v/out, at least 17.2 us at
// 3.35 TB/s; the 0.85 GFLOP of the visible pairs need 12.7 us at
// 67 TFLOP/s.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kSmallLanes = 4;                    // lanes per query row
constexpr int kSmallRows = 32;                    // query rows per block
constexpr int kSmallThreads = kSmallRows * kSmallLanes;
constexpr int kSmallBK = 32;                      // key rows per tile

// at most 128 registers, so four blocks (16 warps) share an SM: on the H100
// that ran faster than 137 registers and three blocks, and than 16-row
// blocks or 16-key tiles
template <int D>
__global__ void __launch_bounds__(kSmallThreads, 4)
flash_fwd_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int hq, int hkv, int sq, int skv, float scale,
                       int causal, int window) {
  constexpr int L = kSmallLanes;
  static_assert(D % (4 * L) == 0, "D must split into float4 per lane");
  constexpr int kVec = D / (4 * L);               // float4 columns per lane
  constexpr int kTile = kSmallBK * D / 4;         // float4 per k (or v) tile
  __shared__ __align__(16) float4 ks[2][kSmallBK][D / 4];
  __shared__ __align__(16) float4 vs[2][kSmallBK][D / 4];

  const int bh = blockIdx.x;                      // b * hq + h
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int sq_offset = skv - sq;
  const int lane = threadIdx.x % L;
  const int row = blockIdx.y * kSmallRows + threadIdx.x / L;
  const bool active = row < sq;
  const int q_pos = sq_offset + row;

  float4 qr[kVec];
  float4 acc[kVec];
  const float4* qp = reinterpret_cast<const float4*>(
      q + (static_cast<int64_t>(bh) * sq + (active ? row : 0)) * D);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 t = qp[i * L + lane];
    qr[i] = active ? make_float4(__fmul_rn(t.x, scale), __fmul_rn(t.y, scale),
                                 __fmul_rn(t.z, scale), __fmul_rn(t.w, scale))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.0f;

  // key tiles any row of this block can see
  const int q_first = sq_offset + blockIdx.y * kSmallRows;
  const int q_last =
      sq_offset + min(static_cast<int>(blockIdx.y) * kSmallRows + kSmallRows, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_first = k_begin / kSmallBK;
  const int t_end = (k_end + kSmallBK - 1) / kSmallBK;
  const float4* kb = reinterpret_cast<const float4*>(k + static_cast<int64_t>(kvh) * skv * D);
  const float4* vb = reinterpret_cast<const float4*>(v + static_cast<int64_t>(kvh) * skv * D);

  // tile t -> buffer buf; rows past skv are zero-filled
  auto load = [&](int t, int buf) {
    const int k0 = t * kSmallBK;
    for (int e = threadIdx.x; e < kTile; e += kSmallThreads) {
      const int j = e / (D / 4);
      const int c = e - j * (D / 4);
      const bool ok = k0 + j < skv;
      const int64_t src = ok ? static_cast<int64_t>(k0 + j) * (D / 4) + c : 0;
      cp_async16(smem_u32(&ks[buf][j][c]), kb + src, ok ? 16 : 0);
      cp_async16(smem_u32(&vs[buf][j][c]), vb + src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (t_first < t_end) load(t_first, 0);
  for (int t = t_first; t < t_end; ++t) {
    const int buf = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load(t + 1, buf ^ 1);          // its buffer was released at the end of t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                 // tile t has landed for every thread

    const int k0 = t * kSmallBK;
    float s[kSmallBK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSmallBK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 kv = ks[buf][j][i * L + lane];
        dot = fmaf(qr[i].x, kv.x, dot);
        dot = fmaf(qr[i].y, kv.y, dot);
        dot = fmaf(qr[i].z, kv.z, dot);
        dot = fmaf(qr[i].w, kv.w, dot);
      }
      // every lane of the warp takes part: the groups are lane-aligned
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = k0 + j;
      bool visible = active && kp < skv;
      if (causal) visible = visible && kp <= q_pos;
      if (window > 0) visible = visible && kp > q_pos - window;
      s[j] = visible ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {        // else this row sees no key yet
      const float alpha = expf(m - m_new);   // exp(-inf) = 0 on the first hit
      float p_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kSmallBK; ++j) {
        s[j] = s[j] == -INFINITY ? 0.0f : expf(s[j] - m_new);
        p_sum += s[j];
      }
      l = alpha * l + p_sum;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kSmallBK; ++j) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float4 vv = vs[buf][j][i * L + lane];
          acc[i].x = fmaf(s[j], vv.x, acc[i].x);
          acc[i].y = fmaf(s[j], vv.y, acc[i].y);
          acc[i].z = fmaf(s[j], vv.z, acc[i].z);
          acc[i].w = fmaf(s[j], vv.w, acc[i].w);
        }
      }
      m = m_new;
    }
    __syncthreads();                 // buffer buf is refilled at tile t + 2
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    float4* op = reinterpret_cast<float4*>(o + (static_cast<int64_t>(bh) * sq + row) * D);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      op[i * L + lane] = make_float4(acc[i].x / denom, acc[i].y / denom,
                                     acc[i].z / denom, acc[i].w / denom);
  }
}

// float4 rows: torch allocations are 256-byte aligned and D * 4 is a
// multiple of 16, so every row of a contiguous tensor starts 16-byte aligned
bool aligned16(const float* q, const float* k, const float* v, const float* o) {
  return ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16) == 0;
}

template <int D>
int launch_small(const float* q, const float* k, const float* v, float* o,
                 int b, int hq, int hkv, int sq, int skv, float scale,
                 int causal, int window, cudaStream_t stream) {
  if (!aligned16(q, k, v, o)) return cudaErrorMisalignedAddress;
  const dim3 grid(static_cast<unsigned int>(b * hq),
                  static_cast<unsigned int>((sq + kSmallRows - 1) / kSmallRows));
  flash_fwd_small_kernel<D><<<grid, kSmallThreads, 0, stream>>>(
      q, k, v, o, hq, hkv, sq, skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kLanes = 8;                  // lanes per query row (split D)
constexpr int kSplitRows = 16;             // query rows per block
constexpr int kSplitThreads = kSplitRows * kLanes;
constexpr int kSplitBK = 16;               // key rows per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
flash_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int hq, int hkv, int sq, int skv, float scale,
                       int causal, int window) {
  static_assert(D % (4 * kLanes) == 0, "D must split into float4 per lane");
  constexpr int kVec = D / (4 * kLanes);   // float4 columns per lane
  __shared__ float4 ks[kSplitBK][D / 4];
  __shared__ float4 vs[kSplitBK][D / 4];

  const int bh = blockIdx.x;               // b * hq + h
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int sq_offset = skv - sq;
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.y * kSplitRows + threadIdx.x / kLanes;
  const bool active = row < sq;
  const int q_pos = sq_offset + row;

  float4 qr[kVec];
  float4 acc[kVec];
  const float4* qp = reinterpret_cast<const float4*>(
      q + (static_cast<int64_t>(bh) * sq + (active ? row : 0)) * D);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 t = qp[i * kLanes + lane];
    qr[i] = active ? make_float4(__fmul_rn(t.x, scale), __fmul_rn(t.y, scale),
                                 __fmul_rn(t.z, scale), __fmul_rn(t.w, scale))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.0f;

  const int q_first = sq_offset + blockIdx.y * kSplitRows;
  const int q_last =
      sq_offset + min(static_cast<int>(blockIdx.y) * kSplitRows + kSplitRows, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const float4* kb = reinterpret_cast<const float4*>(k + static_cast<int64_t>(kvh) * skv * D);
  const float4* vb = reinterpret_cast<const float4*>(v + static_cast<int64_t>(kvh) * skv * D);

  for (int k0 = (k_begin / kSplitBK) * kSplitBK; k0 < k_end; k0 += kSplitBK) {
    __syncthreads();                       // previous tile fully consumed
    for (int e = threadIdx.x; e < kSplitBK * (D / 4); e += kSplitThreads) {
      const int j = e / (D / 4);
      const int c = e - j * (D / 4);
      const bool ok = k0 + j < skv;
      const int64_t src = static_cast<int64_t>(k0 + j) * (D / 4) + c;
      ks[j][c] = ok ? kb[src] : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[j][c] = ok ? vb[src] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float s[kSplitBK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSplitBK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 kv = ks[j][i * kLanes + lane];
        dot = fmaf(qr[i].x, kv.x, dot);
        dot = fmaf(qr[i].y, kv.y, dot);
        dot = fmaf(qr[i].z, kv.z, dot);
        dot = fmaf(qr[i].w, kv.w, dot);
      }
      // every lane of the warp takes part: the groups are lane-aligned
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = k0 + j;
      bool visible = active && kp < skv;
      if (causal) visible = visible && kp <= q_pos;
      if (window > 0) visible = visible && kp > q_pos - window;
      s[j] = visible ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new == -INFINITY) continue;      // this row sees no key yet
    const float alpha = expf(m - m_new);   // exp(-inf) = 0 on the first hit
    float p_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kSplitBK; ++j) {
      s[j] = s[j] == -INFINITY ? 0.0f : expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = alpha * l + p_sum;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kSplitBK; ++j) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 vv = vs[j][i * kLanes + lane];
        acc[i].x = fmaf(s[j], vv.x, acc[i].x);
        acc[i].y = fmaf(s[j], vv.y, acc[i].y);
        acc[i].z = fmaf(s[j], vv.z, acc[i].z);
        acc[i].w = fmaf(s[j], vv.w, acc[i].w);
      }
    }
    m = m_new;
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    float4* op = reinterpret_cast<float4*>(o + (static_cast<int64_t>(bh) * sq + row) * D);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      op[i * kLanes + lane] = make_float4(acc[i].x / denom, acc[i].y / denom,
                                          acc[i].z / denom, acc[i].w / denom);
  }
}

template <int D>
int launch_split(const float* q, const float* k, const float* v, float* o,
                 int b, int hq, int hkv, int sq, int skv, float scale,
                 int causal, int window, cudaStream_t stream) {
  if (!aligned16(q, k, v, o)) return cudaErrorMisalignedAddress;
  const dim3 grid(static_cast<unsigned int>(b * hq),
                  static_cast<unsigned int>((sq + kSplitRows - 1) / kSplitRows));
  flash_fwd_split_kernel<D><<<grid, kSplitThreads, 0, stream>>>(
      q, k, v, o, hq, hkv, sq, skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, hq, sq, d], k/v [b, hkv, skv, d], o [b, hq, sq, d]; all contiguous
// f32. window <= 0 means no local window. Returns a cudaError_t.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int b, int hq,
                                   int hkv, int sq, int skv, int d,
                                   float scale, int causal, int window,
                                   void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sq > skv) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_small<16>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 32: return launch_small<32>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 64: return launch_small<64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 256: return launch_split<256>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}
