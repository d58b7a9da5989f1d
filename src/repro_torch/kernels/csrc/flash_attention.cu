// Flash attention forward for Hopper (sm_90a), f32, and bf16 at head_dim
// 16, 32, 64 and 128.
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
// Head dims 96, 128 and 192 (MLA's q.k heads; yi-6b's and moonshot's GQA
// heads) have their own kernel on the tensor cores, flash_fwd_tc_kernel;
// its design is noted where it starts.
//
// bf16 (flash_attention_bf16): the small kernel and the tensor-core kernel
// are templates on the element type too, with bf16 instances at head_dim
// 16, 32, 64 (OPT-125M's heads) and 128 (yi-6b's), as the TPU kernel
// computes them: q, k and v are widened to f32 where a thread reads them
// (from device memory for q, from shared memory for the K/V tiles, which
// hold bf16 and so half the bytes), the products, the online softmax and P
// stay f32, and only the output is rounded to bf16, to nearest even
// (__float2bfloat16_rn, as XLA's convert). A bf16 value is exact in TF32,
// so K's and V's lo terms are zero in the tensor-core kernel's 3xTF32
// products; Q (scaled) and P keep theirs. Bound: bytes, half the f32
// kernel's at the same shape.
//
// Head dim 256 has its own kernel, flash_fwd_group_kernel (a template on
// D), for recurrentgemma-2b (q [40,10,64,256] against one kv head
// [40,1,64,256], causal, window 2048). Bound at the
// recurrentgemma shape: bytes, 57.7 MB of q/k/v/out, at least 17.2 us at
// 3.35 TB/s; the 0.85 GFLOP of the visible pairs need 12.7 us of f32 FMA
// at 67 TFLOP/s. The two bounds are close, so the copies have to
// overlap dense FMA work. The design, against what held the first version
// (one block per q head and 16 rows, each query row split over 8 lanes)
// back:
// - GQA paid once. A work item is (batch, kv head, tile of query positions,
//   chunk of the group's q heads); its kGRows rows are the (head, position)
//   pairs of those positions. They all see the same keys under the same
//   mask, so each K/V tile is copied into shared memory once for all of
//   them. A chunk holds at most kGRows / kGMinPositions heads; a larger
//   group is split into equal chunks, and rows that the chunk does not fill
//   stay idle (group 3: 3 heads x 26 positions, 78 of 80 rows).
// - Register-blocked f32 products, no shuffles in a dot product. Q, scaled
//   once by __fmul_rn, stays in shared memory for the item's life, its rows
//   padded to D + 4 floats so that eight rows fall in eight bank groups. In
//   S = Q K^T each thread owns 5 rows x 4 keys over a quarter of D (9
//   16-byte shared loads per 80 FMAs, ordered component by component so no
//   FMA waits on the one before); the quarters' partial sums are added in
//   the softmax. In O += P V each thread owns 5 rows x 8 columns of the
//   accumulator (13 loads per 160 FMAs), P and alpha coming through shared
//   memory. The online softmax (running max m, normalizer l, rescale alpha =
//   expf(m - m_new)) runs per row on four lanes, in registers across key
//   tiles, as the TPU kernel's per-tile step. 512 threads at 128 registers:
//   16 warps an SM hide the latency that 8 warps at 255 registers did not.
// - Copies overlap compute, and no thread waits to issue one. Every copy is
//   a TMA bulk copy completing on an mbarrier, issued by warps that have no
//   softmax row: K and V tiles of kGBK keys (one copy each) through a ring
//   of three slots in the order K0 V0 K1 V1 ... (K(t+1) lands while tile t
//   is scored, weighted and summed; V(t+1) while tile t is summed and t+1
//   scored), Q one row a copy. The block is persistent: it walks several
//   items; the tile after an item's last is the next item's first, and the
//   next item's Q is copied as soon as the last scores no longer need Q.
//   (cp.async copies of the same bytes stalled the issuing threads for
//   about 5,000 cycles at each item switch while the card's memory was
//   busy.)
// - Heaviest first. Items are numbered from the last position tile (causal:
//   the most keys) down; round r of block c takes item r * grid + c, or
//   r * grid + grid - 1 - c in odd rounds (a snake), so a block that had a
//   heavy item gets a light one next. Keys past an item's last visible key
//   are left out of both products, and the score warps that hold them are
//   spread over the SM's four schedulers.
// Grid at the hybrid shape: 320 items (8 position tiles of 10 heads x 8
// positions, 1 or 2 key tiles each) on 132 persistent blocks of 512
// threads, one an SM (228,256 B of dynamic shared memory): 2.4 items a
// block, 96 keys of work for the busiest block against 87 on average (a
// greedy longest-first schedule does no better at these item sizes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Element access widened to f32: a bf16 is the top half of the f32 with
// the same value, so widening is exact; stores round to nearest even.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 (8 bytes) as a float4
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

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
// bytes global -> shared by the copy engine (TMA), completing on an mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// wait for the phase with this parity to complete; a copy that never lands
// traps after about a second instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) __trap();
  }
}
// this thread's shared-memory writes, ordered before later TMA writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// an mbarrier whose phase completes after `count` arrivals; a block's
// inits are published together by fence_mbar_init
__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread is done with what the barrier guards (release)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The 3xTF32 split: x = hi + lo, hi TF32 (10-bit mantissa) rounded to
// nearest, ties away, as cvt.rna.tf32.f32 rounds (two integer instructions
// here; the cvt is more on sm_90a), and lo = x - hi, exact in f32. The
// tensor core reads only the top 19 bits of a TF32 operand, so lo goes in
// unrounded: x to about 22 bits. A NaN or infinite x gives a NaN lo.
__device__ __forceinline__ void tc_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// c += a b on the tensor cores in 3xTF32, one m16n8k8 tile: lo.hi, hi.lo,
// then hi.hi into the f32 accumulator (lo.lo, about 2^-22 of a.b, is left
// out). a is the A fragment (rows g, g+8; columns t, t+4), b the B fragment
// (rows t, t+4; column g) of lane 4 g + t; c rows g, g+8, columns 2t, 2t+1.
__device__ __forceinline__ void tc_mma3(float (&c)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh[0]), "r"(bh[1]));
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(bl[0]), "r"(bl[1]));
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(bh[0]), "r"(bh[1]));
}

constexpr int kSmallLanes = 4;                    // lanes per query row
constexpr int kSmallRows = 32;                    // query rows per block
constexpr int kSmallThreads = kSmallRows * kSmallLanes;
constexpr int kSmallBK = 32;                      // key rows per tile

// at most 128 registers, so four blocks (16 warps) share an SM: on the H100
// that ran faster than 137 registers and three blocks, and than 16-row
// blocks or 16-key tiles
constexpr int kSmallBlocksPerSM = 4;

template <int D, typename Elem>
__global__ void __launch_bounds__(kSmallThreads, kSmallBlocksPerSM)
flash_fwd_small_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                       const Elem* __restrict__ v, Elem* __restrict__ o,
                       int hq, int hkv, int sq, int skv, float scale,
                       int causal, int window) {
  constexpr int L = kSmallLanes;
  static_assert(D % (4 * L) == 0, "D must split into 4 columns per lane");
  constexpr int kVec = D / (4 * L);               // 4-column groups per lane
  constexpr int kRowChunks = D * sizeof(Elem) / 16;   // 16-byte copies a row
  constexpr int kChunk = 16 / sizeof(Elem);            // elements a copy
  constexpr int kTile = kSmallBK * kRowChunks;    // copies per k (or v) tile
  __shared__ __align__(16) Elem ks[2][kSmallBK][D];
  __shared__ __align__(16) Elem vs[2][kSmallBK][D];

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
  const Elem* qp = q + (static_cast<int64_t>(bh) * sq + (active ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 t = load4(qp + 4 * (i * L + lane));
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
  const Elem* kb = k + static_cast<int64_t>(kvh) * skv * D;
  const Elem* vb = v + static_cast<int64_t>(kvh) * skv * D;

  // tile t -> buffer buf; rows past skv are zero-filled
  auto load = [&](int t, int buf) {
    const int k0 = t * kSmallBK;
    for (int e = threadIdx.x; e < kTile; e += kSmallThreads) {
      const int j = e / kRowChunks;
      const int c = (e - j * kRowChunks) * kChunk;
      const bool ok = k0 + j < skv;
      const int64_t src = ok ? static_cast<int64_t>(k0 + j) * D + c : 0;
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
        const float4 kv = load4(&ks[buf][j][4 * (i * L + lane)]);
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
          const float4 vv = load4(&vs[buf][j][4 * (i * L + lane)]);
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
    Elem* op = o + (static_cast<int64_t>(bh) * sq + row) * D;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      store4(op + 4 * (i * L + lane),
             make_float4(acc[i].x / denom, acc[i].y / denom,
                         acc[i].z / denom, acc[i].w / denom));
  }
}

// 16-byte rows: torch allocations are 256-byte aligned and D times the
// element size is a multiple of 16, so every row of a contiguous tensor
// starts 16-byte aligned
bool aligned16(const void* q, const void* k, const void* v, const void* o) {
  return ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16) == 0;
}

template <int D, typename Elem>
int launch_small(const Elem* q, const Elem* k, const Elem* v, Elem* o,
                 int b, int hq, int hkv, int sq, int skv, float scale,
                 int causal, int window, cudaStream_t stream) {
  if (!aligned16(q, k, v, o)) return cudaErrorMisalignedAddress;
  const dim3 grid(static_cast<unsigned int>(b * hq),
                  static_cast<unsigned int>((sq + kSmallRows - 1) / kSmallRows));
  flash_fwd_small_kernel<D, Elem><<<grid, kSmallThreads, 0, stream>>>(
      q, k, v, o, hq, hkv, sq, skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}


// head_dim 256: blocks of kGRows (head, position) rows of one kv head
constexpr int kGThreads = 512;
constexpr int kGBlocksPerSM = 1;
constexpr int kGRows = 80;                 // (q head, position) rows an item
constexpr int kGMinPositions = 8;          // positions an item at least
constexpr int kGBK = 32;                   // keys a K/V tile
constexpr int kGRowsPerThread = 5;         // rows a thread owns, in both products
constexpr int kGKeysPerThread = 4;         // keys a thread owns in S
constexpr int kGSlots = 3;                 // K/V ring: K0 V0 K1 V1 ...

template <int D>
struct GroupShape {
  static constexpr int kD4 = D / 4;                         // float4 a row
  static constexpr int kRG = kGRows / kGRowsPerThread;      // row groups
  static constexpr int kKG = kGBK / kGKeysPerThread;        // key groups
  static constexpr int kDS = kGThreads / (kRG * kKG);       // D slices of S
  static constexpr int kSliceD = D / kDS;
  // P V: kCG column groups of kPC float4 columns and kPRG row groups of
  // kPRT rows; the two tiles share rows
  static constexpr int kCG = kGThreads / kRG;
  static constexpr int kPC = kD4 / kCG;                     // float4 a thread
  static constexpr int kPRG = kGThreads / kCG;              // row groups
  static constexpr int kPRT = kGRows / kPRG;                // rows a thread
  static constexpr int kPVThreads = kPRG * kCG;
  static constexpr int kQStride = D + 4;                    // padded Q row
  static constexpr int kSStride = kGBK + 4;                 // padded S row
  // softmax lanes a row: as many as the block's threads allow, up to 4
  static constexpr int kSL = kGThreads >= 4 * kGRows ? 4
                           : kGThreads >= 2 * kGRows ? 2 : 1;
  // mbarriers (Q's, one a ring slot), Q, the K/V ring, S partial sums,
  // alpha, l
  static constexpr int kFloats = 8 + kGRows * kQStride + kGSlots * kGBK * D
                                 + kDS * kGRows * kSStride + 2 * kGRows;
  static_assert(kGRows % kGRowsPerThread == 0 && kRG % 8 == 0,
                "eight row groups a quarter warp");
  static_assert(kGKeysPerThread % 4 == 0 && kGBK % kGKeysPerThread == 0,
                "keys a thread in float4");
  static_assert(kRG * kKG * kDS == kGThreads && kSliceD % 4 == 0,
                "S tile must cover the block's threads");
  static_assert(kPRG * kPRT == kGRows && kD4 % kCG == 0 && kCG >= 8 &&
                kPVThreads <= kGThreads, "P V tile must cover the rows");
  static_assert(kGBK % (4 * kSL) == 0, "softmax lanes split the key tile");
  static_assert(kRG <= 32 && (kKG * kRG) % 32 == 0, "S warps");
  // warps with no softmax row copy Q and K/V tiles (warp 0 if none)
  static constexpr int kCopyWarp = (kGRows * kSL + 31) / 32 < kGThreads / 32
                                   ? (kGRows * kSL + 31) / 32 : 0;
  static constexpr int kCopyWarps = kCopyWarp > 0 ? kGThreads / 32 - kCopyWarp : 1;
};

// One work item: the kGRows rows of (kv head bkv, position tile, head chunk)
// and the key tiles they can see.
struct GroupItem {
  int b, bkv, h0, heads, p0, n_pos, k_begin, k_end, t_first, t_end;
};

struct GroupArgs {
  int hq, hkv, sq, skv, causal, window, chunk_heads, chunks, positions,
      n_tiles, n_items;
  float scale;
};

__device__ __forceinline__ GroupItem group_item(const GroupArgs& a, int index) {
  GroupItem it;
  const int per_tile = a.n_items / a.n_tiles;        // b * hkv * chunks
  // index 0 is the last position tile: causal, the most keys
  const int tile = a.n_tiles - 1 - index / per_tile;
  const int rest = index % per_tile;
  const int chunk = rest % a.chunks;
  const int group = a.hq / a.hkv;
  it.bkv = rest / a.chunks;
  it.b = it.bkv / a.hkv;
  it.h0 = (it.bkv % a.hkv) * group + chunk * a.chunk_heads;
  it.heads = min(a.chunk_heads, group - chunk * a.chunk_heads);
  it.p0 = tile * a.positions;
  it.n_pos = min(a.positions, a.sq - it.p0);
  const int q_first = a.skv - a.sq + it.p0;
  const int q_last = q_first + it.n_pos - 1;
  it.k_end = a.causal ? min(a.skv, q_last + 1) : a.skv;
  it.k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  it.t_first = it.k_begin / kGBK;
  it.t_end = (it.k_end + kGBK - 1) / kGBK;   // > t_first: a row sees its key
  return it;
}

// row r of an item is (q head h0 + r / positions, position p0 + r %
// positions); its q/o row, or -1 where the item leaves row r idle
__device__ __forceinline__ int64_t group_row(const GroupArgs& a,
                                             const GroupItem& it, int r) {
  const int hc = r / a.positions;
  const int p = r - hc * a.positions;
  return hc < it.heads && p < it.n_pos
             ? (static_cast<int64_t>(it.b) * a.hq + it.h0 + hc) * a.sq + it.p0 + p
             : -1;
}

template <int D>
__global__ void __launch_bounds__(kGThreads, kGBlocksPerSM)
flash_fwd_group_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       const GroupArgs a) {
  using G = GroupShape<D>;
  constexpr int R = kGRows;
  constexpr int RT = kGRowsPerThread;
  constexpr int KT = kGKeysPerThread;
  extern __shared__ __align__(16) float smem[];
  static_assert(kGSlots <= 3, "four mbarriers in the first 32 bytes");
  const uint32_t q_bar = smem_u32(smem);            // Q's mbarrier
  const uint32_t kv_bar = q_bar + 8;                 // slot s: kv_bar + 8 s
  float* qs = smem + 8;                              // [R][kQStride]
  float* ring = qs + R * G::kQStride;                // [kGSlots][kGBK][D]
  float* ss = ring + kGSlots * kGBK * D;             // [kDS][R][kSStride]
  float* alpha_s = ss + G::kDS * R * G::kSStride;    // [R]
  float* l_s = alpha_s + R;                          // [R]
  const int tid = threadIdx.x;
  const int copier = tid - 32 * G::kCopyWarp;        // 0: the copy thread

  // round r's item: heaviest first, in snake order over the blocks so that
  // a block with a heavy item in one round gets a light one in the next
  auto item_index = [&](int r) {
    return r * static_cast<int>(gridDim.x)
           + ((r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                      : static_cast<int>(blockIdx.x));
  };
  // tile t of k or v (of kv head bkv) -> ring slot, one bulk copy of its
  // rows below skv (contiguous) by the copy thread; the block writes zeros
  // past skv (P is 0 there, and 0 x NaN would not be). Called by every
  // thread.
  auto load_tile = [&](const float* base, int bkv, int t, int slot) {
    const int k0 = t * kGBK;
    const int rows = min(kGBK, a.skv - k0);
    float* dst = ring + slot * kGBK * D;
    if (rows < kGBK) {
      for (int e = tid; e < (kGBK - rows) * G::kD4; e += kGThreads)
        reinterpret_cast<float4*>(dst + rows * D)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      fence_proxy_async();
    }
    if (copier == 0) {
      const uint32_t bar = kv_bar + 8 * slot;
      mbar_expect(bar, rows * D * 4);
      bulk_copy(smem_u32(dst), base + (static_cast<int64_t>(bkv) * a.skv + k0) * D,
                rows * D * 4, bar);
    }
  };
  // ring position p (K(t) at p, V(t) at p + 1) is phase p / kGSlots of
  // slot p % kGSlots's mbarrier
  auto wait_slot = [&](int p) {
    mbar_wait(kv_bar + 8 * (p % kGSlots), (p / kGSlots) & 1);
  };
  // the item's Q rows, one bulk copy a row by the copy warps (idle in the
  // softmax), after a barrier that follows expect_q; rows the item leaves
  // idle keep what they held (their scores are masked, their P is 0)
  auto expect_q = [&](const GroupItem& it) {
    if (copier == 0) mbar_expect(q_bar, it.heads * it.n_pos * D * 4);
  };
  auto load_q = [&](const GroupItem& it) {
    if (copier < 0 || copier >= 32 * G::kCopyWarps) return;
    for (int r = copier; r < R; r += 32 * G::kCopyWarps) {
      const int64_t row = group_row(a, it, r);
      if (row >= 0)
        bulk_copy(smem_u32(qs + r * G::kQStride), q + row * D, D * 4, q_bar);
    }
  };

  // softmax lanes: row srow, lane slane of kSL; m and l live here
  const int srow = tid / G::kSL;
  const int slane = tid % G::kSL;
  const bool s_active = srow < R;
  const bool s_warp = tid - tid % 32 < R * G::kSL;   // warp holds a row
  // S coordinates: rows rg + kRG i, keys KT kg .. KT kg + KT - 1, D slice
  // ds. A warp holds 32 / kRG key groups of one slice; warp w runs on
  // scheduler w % 4, so the slice follows w and the key groups w / kDS:
  // every scheduler gets every key group, and the groups a partial tile
  // leaves out idle all four alike.
  const int rg = tid % G::kRG;
  const int kg = (32 / G::kRG) * (tid / 32 / G::kDS) + (tid % 32) / G::kRG;
  const int ds = (tid / 32) % G::kDS;
  // P V coordinates: rows pr + kPRG i, float4 columns cg + kCG c
  const int cg = tid % G::kCG;
  const int pr = tid / G::kCG;
  const bool pv_active = tid < G::kPVThreads;

  int round = 0;                                     // items done
  GroupItem cur = group_item(a, item_index(0));      // gridDim.x <= n_items
  if (tid == 0) {
    mbar_init(q_bar);
    for (int slot = 0; slot < kGSlots; ++slot) mbar_init(kv_bar + 8 * slot);
    fence_proxy_async();
  }
  __syncthreads();
  expect_q(cur);
  __syncthreads();
  // every copy of the kernel goes by TMA
  load_q(cur);
  load_tile(k, cur.bkv, cur.t_first, 0);
  load_tile(v, cur.bkv, cur.t_first, 1);

  float4 acc[G::kPRT][G::kPC];
  float m = -INFINITY;
  float l = 0.0f;
  int t = cur.t_first;
  int pos = 0;                                       // ring position of K(t)
  bool fresh = true;                                 // first tile of cur
  // K(t + 1) is copied after (A), V(t + 1) after (B), the next item's Q
  // after the last tile's (B); item n's Q is phase n of q_bar.
  while (true) {
    wait_slot(pos);                                  // K(t) has landed
    if (fresh) {
      mbar_wait(q_bar, round & 1);                   // Q has landed
      // scale Q in place; (A) shows it, and the fence orders these writes
      // before the next item's TMA writes to the same rows
      for (int e = tid; e < R * G::kD4; e += kGThreads) {
        const int r = e / G::kD4;
        float4* p = reinterpret_cast<float4*>(qs + r * G::kQStride
                                              + 4 * (e - r * G::kD4));
        const float4 x = *p;
        *p = make_float4(__fmul_rn(x.x, a.scale), __fmul_rn(x.y, a.scale),
                         __fmul_rn(x.z, a.scale), __fmul_rn(x.w, a.scale));
      }
      fence_proxy_async();
#pragma unroll
      for (int i = 0; i < G::kPRT; ++i)
#pragma unroll
        for (int c = 0; c < G::kPC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      m = -INFINITY;
      l = 0.0f;
    }
    __syncthreads();         // (A) K(t) and Q shown; P, alpha of t - 1 read

    // the tile after t: this item's next, or the next item's first
    const bool last = t + 1 >= cur.t_end;
    const int next_index = item_index(round + 1);
    const bool has_next = !last || next_index < a.n_items;
    GroupItem nxt = last && has_next ? group_item(a, next_index) : cur;
    const int nt = last ? nxt.t_first : t + 1;
    // V(t - 1)'s slot is free
    if (has_next) load_tile(k, nxt.bkv, nt, (pos + 2) % kGSlots);
    if (last && has_next) expect_q(nxt);             // copied after (B)
    const int k0 = t * kGBK;

    // S = Q K^T: RT x KT partial sums over D slice ds
    if (k0 + KT * kg < cur.k_end) {
      float sacc[RT][KT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) sacc[i][j] = 0.0f;
      const float* qt = qs + rg * G::kQStride + ds * G::kSliceD;
      const float* kt = ring + (pos % kGSlots) * kGBK * D + KT * kg * D
                        + ds * G::kSliceD;
#pragma unroll 1
      for (int d = 0; d < G::kSliceD; d += 4) {
        float4 qv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qt + i * G::kRG * G::kQStride + d);
        float4 kv[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kt + j * D + d);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < KT; ++j) sacc[i][j] = fmaf(qv[i].x, kv[j].x, sacc[i][j]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < KT; ++j) sacc[i][j] = fmaf(qv[i].y, kv[j].y, sacc[i][j]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < KT; ++j) sacc[i][j] = fmaf(qv[i].z, kv[j].z, sacc[i][j]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < KT; ++j) sacc[i][j] = fmaf(qv[i].w, kv[j].w, sacc[i][j]);
      }
      float* st = ss + ds * R * G::kSStride + KT * kg;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KT; j += 4)
          *reinterpret_cast<float4*>(st + (rg + i * G::kRG) * G::kSStride + j) =
              make_float4(sacc[i][j], sacc[i][j + 1], sacc[i][j + 2], sacc[i][j + 3]);
    }
    __syncthreads();         // (B) every slice's partial scores written

    // online softmax: P (in slice 0's place) and alpha for each row
    if (s_warp) {
      constexpr int kPer = kGBK / G::kSL;
      const int r = s_active ? srow : 0;
      const int64_t row = s_active ? group_row(a, cur, r) : -1;
      const int q_pos = a.skv - a.sq + cur.p0 + r % a.positions;
      float s[kPer];
      float m_tile = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kPer; ++jj) {
        const int j = jj * G::kSL + slane;
        float x = ss[r * G::kSStride + j];
#pragma unroll
        for (int sl = 1; sl < G::kDS; ++sl)
          x += ss[(sl * R + r) * G::kSStride + j];
        const int kp = k0 + j;
        bool visible = row >= 0 && kp < a.skv;
        if (a.causal) visible = visible && kp <= q_pos;
        if (a.window > 0) visible = visible && kp > q_pos - a.window;
        s[jj] = visible ? x : -INFINITY;
        m_tile = fmaxf(m_tile, s[jj]);
      }
#pragma unroll
      for (int off = G::kSL / 2; off > 0; off /= 2)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
      const float m_new = fmaxf(m, m_tile);
      float alpha = 1.0f;
      float p_sum = 0.0f;
      if (m_new != -INFINITY) {          // else this row sees no key yet
        alpha = expf(m - m_new);         // exp(-inf) = 0 on the first hit
#pragma unroll
        for (int jj = 0; jj < kPer; ++jj) {
          s[jj] = s[jj] == -INFINITY ? 0.0f : expf(s[jj] - m_new);
          p_sum += s[jj];
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < kPer; ++jj) s[jj] = 0.0f;
      }
#pragma unroll
      for (int off = G::kSL / 2; off > 0; off /= 2)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      l = alpha * l + p_sum;
      m = m_new;
      if (s_active) {
#pragma unroll
        for (int jj = 0; jj < kPer; ++jj)
          ss[r * G::kSStride + jj * G::kSL + slane] = s[jj];
        if (slane == 0) alpha_s[r] = alpha;
      }
    }
    // every thread is past (B): K(t)'s slot is free, and at an item's last
    // tile so is Q
    if (has_next) {
      load_tile(v, nxt.bkv, nt, pos % kGSlots);
      if (last) load_q(nxt);
    }
    wait_slot(pos + 1);                              // V(t) has landed
    __syncthreads();         // (C) P, alpha and V(t) shown

    // O = alpha O + P V over the keys the item can see in this tile
    if (pv_active) {
      const int j_lo = max(0, cur.k_begin - k0) & ~3;
      const int j_hi = min(kGBK, cur.k_end - k0);
#pragma unroll
      for (int i = 0; i < G::kPRT; ++i) {
        const float al = alpha_s[pr + i * G::kPRG];
#pragma unroll
        for (int c = 0; c < G::kPC; ++c) {
          acc[i][c].x *= al; acc[i][c].y *= al; acc[i][c].z *= al; acc[i][c].w *= al;
        }
      }
      const float* pt = ss + pr * G::kSStride;
      const float* vt = ring + ((pos + 1) % kGSlots) * kGBK * D + 4 * cg;
#pragma unroll 1
      for (int j = j_lo; j < j_hi; j += 4) {
        float4 p[G::kPRT];
#pragma unroll
        for (int i = 0; i < G::kPRT; ++i)
          p[i] = *reinterpret_cast<const float4*>(pt + i * G::kPRG * G::kSStride + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 vv[G::kPC];
#pragma unroll
          for (int c = 0; c < G::kPC; ++c)
            vv[c] = *reinterpret_cast<const float4*>(vt + (j + jj) * D + 4 * G::kCG * c);
#pragma unroll
          for (int i = 0; i < G::kPRT; ++i) {
            const float w = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                          : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int c = 0; c < G::kPC; ++c) {
              acc[i][c].x = fmaf(w, vv[c].x, acc[i][c].x);
              acc[i][c].y = fmaf(w, vv[c].y, acc[i][c].y);
              acc[i][c].z = fmaf(w, vv[c].z, acc[i][c].z);
              acc[i][c].w = fmaf(w, vv[c].w, acc[i][c].w);
            }
          }
        }
      }
    }

    if (last) {              // the item is done: normalize and store
      if (s_active && slane == 0) l_s[srow] = l;
      __syncthreads();       // (D) l shown
#pragma unroll
      for (int i = 0; i < G::kPRT; ++i) {
        const int r = pr + i * G::kPRG;
        const int64_t row = pv_active ? group_row(a, cur, r) : -1;
        if (row < 0) continue;
        const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
        float4* op = reinterpret_cast<float4*>(o + row * D) + cg;
#pragma unroll
        for (int c = 0; c < G::kPC; ++c)
          op[G::kCG * c] = make_float4(acc[i][c].x * inv, acc[i][c].y * inv,
                                       acc[i][c].z * inv, acc[i][c].w * inv);
      }
      if (!has_next) break;
      ++round;
      cur = nxt;
    }
    fresh = last;
    t = nt;
    pos += 2;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int D>
int group_smem_bytes() {
  return static_cast<int>(sizeof(float)) * GroupShape<D>::kFloats;
}

// dynamic shared memory allowed so far, and blocks the card holds at once,
// for flash_fwd_group_kernel<D>
template <int D>
int allowed_group_smem = 0;
template <int D>
int resident_group_blocks = 0;

template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* out) {
  if (*out > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return cudaSuccess;
}

template <int D>
int launch_group(const float* q, const float* k, const float* v, float* o,
                 int b, int hq, int hkv, int sq, int skv, float scale,
                 int causal, int window, cudaStream_t stream) {
  if (!aligned16(q, k, v, o)) return cudaErrorMisalignedAddress;
  // an item holds at most kGRows / kGMinPositions heads; a larger group
  // splits into equal chunks, and positions fill the rows the chunk leaves
  GroupArgs a;
  const int group = hq / hkv;
  const int max_heads = kGRows / kGMinPositions;
  a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.causal = causal;
  a.window = window; a.scale = scale;
  a.chunks = (group + max_heads - 1) / max_heads;
  a.chunk_heads = (group + a.chunks - 1) / a.chunks;
  a.positions = kGRows / a.chunk_heads;
  a.n_tiles = (sq + a.positions - 1) / a.positions;
  const int64_t items = static_cast<int64_t>(a.n_tiles) * b * hkv * a.chunks;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  const int smem = group_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_group_kernel<D>, smem,
                               &allowed_group_smem<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many blocks as the card holds at once, each walking
  // its items
  err = resident_blocks(flash_fwd_group_kernel<D>, kGThreads, smem,
                        &resident_group_blocks<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min(a.n_items, resident_group_blocks<D>);
  flash_fwd_group_kernel<D><<<blocks, kGThreads, smem, stream>>>(q, k, v, o, a);
  return static_cast<int>(cudaGetLastError());
}

// Head dims 96, 128 and 192 (flash_fwd_tc_kernel, a template on D): MLA's
// q.k heads, minicpm3-4b's 64 + 32 ([40,40,64,96], causal, group 1) and
// deepseek-v2's 128 + 64 ([40,128,64,192] on 128 kv heads), v padded to
// the q.k width by the model; and GQA at 128, moonshot's training shape
// ([40,16,64,128], causal, group 1), yi-6b's prefill (q [4,32,32,128] on
// k/v [4,4,32,128], group 8) and a 2048-token prompt (q [1,32,2048,128] on
// [1,4,2048,128]). Bound on the H100 (3.35 TB/s, 495 TFLOP/s in TF32, at
// 700 W): bytes, 157.3 MB (96) and 1.007 GB (192) of q/k/v/out, at least
// 47 us and 300 us; the visible pairs' 8.2 GFLOP at 192 need 0.12 ms of
// f32 FMA at 67 TFLOP/s, and their three TF32 passes 0.05 ms. At 128:
// bytes, 0.0250 ms (moonshot, 83.9 MB) and 0.0014 ms (yi-6b's prefill,
// 4.7 MB); at the 2048-token prompt operations, its 67,141,632 visible
// pairs in three TF32 passes (3 x 4 x 128 flops a pair) 0.2083 ms against
// 0.0225 ms of bytes. Design:
// - Work items of kTcRows = 64 (q head, position) rows of one kv head's
//   query group, numbered as the group kernel numbers them (position tile
//   x head chunk, heaviest first, persistent blocks in snake order): at
//   group 1 and Sq = 64 an item is one head's 64 positions, no row idle.
//   All rows of an item see the same keys, so each K/V tile is copied once.
// - A block is four consumer warps of 16 rows and one producer warp. The
//   producer copies by TMA, one bulk copy a row: the item's first K tile,
//   its Q (after the consumers released the last item's Q), then V and K
//   tiles of kTcBK keys through a ring of kSlots slots, each completing on
//   its `full` mbarrier and refilled after all 128 consumer threads arrived
//   on its `empty` one; rows past Skv are zeroed (P is 0 there, and 0 x NaN
//   would not be). The next item's Q and first tiles land while this item
//   finishes.
// - Both products on the tensor cores: mma.sync m16n8k8 in 3xTF32
//   (tc_split, tc_mma3), f32 accumulators; one TF32 pass misses the f32
//   plain version by about 1e-3, three by about 1e-6. wgmma's TF32 form
//   takes B only K-major, and V is N-major in P V. In S = (Q scale) K^T a
//   lane loads Q and K as float2 (rows padded to D + 8 floats, as V's, so
//   the fragment loads hit 32 banks), and each k-step's three products are
//   summed from zero and added to S in f32: summed in the tensor core's
//   accumulator, scores lose low bits as they grow (at inputs x8 the
//   result strayed twice as far from the f64 value as attention_plain).
//   One k-step at a time keeps 168 registers, the cap for two blocks an
//   SM, without a spill. S stays in registers as the warp's 16 x kTcBK C
//   fragment, and P V takes it as its A fragment in place: its k (key)
//   index is permuted so that a lane's columns t and t + 4 are the keys
//   2t and 2t + 1 it holds (on the H100 no slower than moving P through
//   shared memory or by shuffles, and nothing moves).
// - Online softmax on the fragment: a row's four lanes reduce its max with
//   two xor shuffles; alpha = expf(m - m_new) rescales the accumulator each
//   tile, as the TPU kernel's step; each lane keeps its part of the
//   normalizer, summed over the quad once an item.
// - Causal and window skipping by the warp: a K/V tile that none of the
//   warp's rows can see, and an 8-key block of P V, are left out; masks
//   are applied only in blocks that cross the diagonal, the window's edge
//   or Skv. At 96 and 128 a visible tile's four 8-key blocks of S are all
//   scored, with no branch between them (the masks clear those the warp
//   cannot see), so that their three-deep mma chains overlap: scored one
//   block at a time behind a branch each, S took three times P V's time
//   for as many products. At 192 that spills, and each block the warp
//   cannot see is skipped.
// - Fixed order of every sum and no atomics: two calls are bitwise equal.
constexpr int kTcWarps = 4;                       // consumer warps, 16 rows each
constexpr int kTcThreads = 32 * (kTcWarps + 1);   // and the producer warp
constexpr int kTcRows = 16 * kTcWarps;            // (q head, position) rows an item
constexpr int kTcMinPositions = 16;               // positions an item at least
constexpr int kTcBK = 32;                         // keys a K/V tile

template <int D>
struct TcShape {
  // K/V ring slots and blocks an SM: two blocks of 102,448 B at 192 and of
  // 87,104 B at 128, three of 66,624 B at 96
  static constexpr int kSlots = D == 192 ? 2 : 3;
  static constexpr int kBlocksPerSM = D == 96 ? 3 : 2;
  // every 8-key block of a visible tile scored (see above; at 192 the
  // branch-free S spills)
  static constexpr bool kScoreWholeTile = D != 192;
  // Q, K, V rows in elements (f32 or bf16): the fragment loads of a warp
  // hit 32 banks at either size (rows 8 words apart in f32, 4 in bf16)
  static constexpr int kStride = D + 8;
  static constexpr int kSlotElems = kTcBK * kStride;
  // mbarriers: Q full and empty, then each slot's full, then its empty
  static constexpr int kBars = 2 + 2 * kSlots;
  static constexpr int kBarFloats = (2 * kBars + 3) / 4 * 4;
  static constexpr int kElems = kTcRows * kStride + kSlots * kSlotElems;
  static_assert(D % 8 == 0 && kTcBK % 8 == 0, "8-column k-steps, 8-key blocks");
  static_assert(kStride % 32 == 8, "conflict-free fragment loads");
};

template <int D, typename Elem>
__global__ void __launch_bounds__(kTcThreads, TcShape<D>::kBlocksPerSM)
flash_fwd_tc_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                    const Elem* __restrict__ v, Elem* __restrict__ o,
                    const GroupArgs a) {
  using T = TcShape<D>;
  constexpr int S = T::kSlots;
  constexpr int NB = kTcBK / 8;                   // 8-key blocks a tile
  constexpr int RS = T::kStride;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(Elem));
  extern __shared__ __align__(16) float smem[];
  const uint32_t q_full = smem_u32(smem);
  const uint32_t q_empty = q_full + 8;
  const uint32_t full0 = q_full + 16;             // slot s: full0 + 8 s
  const uint32_t empty0 = full0 + 8 * S;          // slot s: empty0 + 8 s
  Elem* qs = reinterpret_cast<Elem*>(smem + T::kBarFloats);   // [kTcRows][RS]
  Elem* ring = qs + kTcRows * RS;                 // [S][kTcBK][RS]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kConsumerThreads = 32 * kTcWarps;

  if (threadIdx.x == 0) {
    mbar_init_count(q_full, 1);
    mbar_init_count(q_empty, kConsumerThreads);
    for (int s = 0; s < S; ++s) {
      mbar_init_count(full0 + 8 * s, 1);
      mbar_init_count(empty0 + 8 * s, kConsumerThreads);
    }
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();

  // round r's item: heaviest first, in snake order over the blocks
  auto item_index = [&](int r) {
    return r * static_cast<int>(gridDim.x)
           + ((r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                      : static_cast<int>(blockIdx.x));
  };

  if (warp == kTcWarps) {
    // the producer, in the order the consumers read: K(t0), the item's Q,
    // V(t0), then K(t) and V(t); ring position p is phase p / S of slot
    // p % S
    int fill = 0;
    auto load_tile = [&](const Elem* base, int bkv, int t) {
      const int slot = fill % S;
      if (fill >= S) mbar_wait(empty0 + 8 * slot, (fill / S - 1) & 1);
      const int k0 = t * kTcBK;
      const int rows = min(kTcBK, a.skv - k0);
      Elem* dst = ring + slot * T::kSlotElems;
      if (rows < kTcBK) {
        constexpr int kChunks = kRowBytes / 16;   // 16-byte stores a row
        for (int e = lane; e < (kTcBK - rows) * kChunks; e += 32)
          reinterpret_cast<uint4*>(dst + (rows + e / kChunks) * RS)[e % kChunks] =
              make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();
      }
      __syncwarp();
      const uint32_t bar = full0 + 8 * slot;
      if (lane == 0) mbar_expect(bar, rows * kRowBytes);
      __syncwarp();
      const Elem* src = base + (static_cast<int64_t>(bkv) * a.skv + k0) * D;
      for (int r = lane; r < rows; r += 32)
        bulk_copy(smem_u32(dst + r * RS), src + static_cast<int64_t>(r) * D,
                  kRowBytes, bar);
      ++fill;
    };
    for (int round = 0;; ++round) {
      const int index = item_index(round);
      if (index >= a.n_items) break;
      const GroupItem it = group_item(a, index);
      const int t_first = it.k_begin / kTcBK;
      const int t_end = (it.k_end + kTcBK - 1) / kTcBK;
      for (int t = t_first; t < t_end; ++t) {
        load_tile(k, it.bkv, t);
        if (t == t_first) {
          // the item's Q rows, once the last item's scores are done
          if (round > 0) mbar_wait(q_empty, (round - 1) & 1);
          if (lane == 0) mbar_expect(q_full, it.heads * it.n_pos * kRowBytes);
          __syncwarp();
          for (int r = lane; r < kTcRows; r += 32) {
            const int64_t row = group_row(a, it, r);
            if (row >= 0) bulk_copy(smem_u32(qs + r * RS), q + row * D, kRowBytes, q_full);
          }
        }
        load_tile(v, it.bkv, t);
      }
    }
    return;
  }

  // a consumer warp: rows 16 warp + g and 16 warp + g + 8 of the item
  const int g = lane >> 2;
  const int tq = lane & 3;
  const Elem* q_lane = qs + (16 * warp + g) * RS + 2 * tq;
  int fill = 0;
  for (int round = 0;; ++round) {
    const int index = item_index(round);
    if (index >= a.n_items) break;
    const GroupItem it = group_item(a, index);
    const int t_first = it.k_begin / kTcBK;
    const int t_end = (it.k_end + kTcBK - 1) / kTcBK;
    const int r_a = 16 * warp + g;
    const int r_b = r_a + 8;
    // q/o rows (-1: the item leaves the row idle); launch_tc checks that
    // every row index fits an int
    const int row_a = static_cast<int>(group_row(a, it, r_a));
    const int row_b = static_cast<int>(group_row(a, it, r_b));
    const int pos_a = a.skv - a.sq + it.p0 + r_a % a.positions;
    const int pos_b = a.skv - a.sq + it.p0 + r_b % a.positions;
    // the positions of the warp's rows, and the keys any of them can see
    int lo = min(row_a >= 0 ? pos_a : 0x7fffffff, row_b >= 0 ? pos_b : 0x7fffffff);
    int hi = max(row_a >= 0 ? pos_a : -1, row_b >= 0 ? pos_b : -1);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    // tile t's 8-key blocks [b_lo, b_hi) that the warp can see
    auto blocks = [&](int t, int& b_lo, int& b_hi) {
      const int k_end = hi < 0 ? 0 : a.causal ? min(a.skv, hi + 1) : a.skv;
      const int k_begin = hi < 0 || a.window <= 0 ? 0 : max(0, lo - a.window + 1);
      b_lo = max(0, k_begin - t * kTcBK) / 8;
      b_hi = min(NB, (k_end - t * kTcBK + 7) / 8);
    };

    // tile t's scores (Q scale) K^T into sc, masked (lane: keys 2t, 2t + 1
    // of each block, rows g and g + 8) where a block crosses the
    // diagonal, the window's edge or Skv; -inf in blocks left out
    auto scores = [&](int t, float (&sc)[NB][4]) {
      int b_lo, b_hi;
      blocks(t, b_lo, b_hi);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      const int slot = fill % S;
      mbar_wait(full0 + 8 * slot, (fill / S) & 1);
      if (b_lo < b_hi) {
        const Elem* k_lane = ring + slot * T::kSlotElems + g * RS + 2 * tq;
#pragma unroll 2
        for (int d0 = 0; d0 < D; d0 += 8) {
          // one k-step: columns 2t and 2t + 1 of these 8 as A's columns t
          // and t + 4 and B's rows t and t + 4 (the same permutation of the
          // k index in both), so a lane loads each operand as a pair
          const float2 xa = load2(q_lane + d0);
          const float2 xb = load2(q_lane + 8 * RS + d0);
          uint32_t ah[4], al[4];
          tc_split(__fmul_rn(xa.x, a.scale), ah[0], al[0]);
          tc_split(__fmul_rn(xb.x, a.scale), ah[1], al[1]);
          tc_split(__fmul_rn(xa.y, a.scale), ah[2], al[2]);
          tc_split(__fmul_rn(xb.y, a.scale), ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (!T::kScoreWholeTile && (j < b_lo || j >= b_hi)) continue;
            const float2 y = load2(k_lane + 8 * j * RS + d0);
            uint32_t bh[2], bl[2];
            tc_split(y.x, bh[0], bl[0]);
            tc_split(y.y, bh[1], bl[1]);
            // the k-step's products summed from zero, then added in f32:
            // the tensor core's own running sum drops low bits as it grows
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            tc_mma3(z, ah, al, bh, bl);
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += z[e];
          }
        }
      }
      mbar_arrive(empty0 + 8 * slot);                // K(t) read
      ++fill;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int kb = t * kTcBK + 8 * j;
        if (j < b_lo || j >= b_hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = -INFINITY;
          continue;
        }
        const bool whole = kb + 8 <= a.skv && (!a.causal || kb + 7 <= lo)
                           && (a.window <= 0 || kb > hi - a.window);
        if (whole) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kb + 2 * tq + (e & 1);
          const int pos = e < 2 ? pos_a : pos_b;
          bool visible = kp < a.skv;
          if (a.causal) visible = visible && kp <= pos;
          if (a.window > 0) visible = visible && kp > pos - a.window;
          if (!visible) sc[j][e] = -INFINITY;
        }
      }
    };

    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY;       // rows g and g + 8
    float l_a = 0.0f, l_b = 0.0f;                 // this lane's part
    float alpha_a = 1.0f, alpha_b = 1.0f;         // tile t's rescale

    // online softmax of tile t: the row's max over its quad; sc becomes P
    auto softmax = [&](int t, float (&sc)[NB][4]) {
      int b_lo, b_hi;
      blocks(t, b_lo, b_hi);
      float mt_a = -INFINITY, mt_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mt_a = fmaxf(mt_a, fmaxf(sc[j][0], sc[j][1]));
        mt_b = fmaxf(mt_b, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mt_a = fmaxf(mt_a, __shfl_xor_sync(0xffffffffu, mt_a, off));
        mt_b = fmaxf(mt_b, __shfl_xor_sync(0xffffffffu, mt_b, off));
      }
      const float mn_a = fmaxf(m_a, mt_a);
      const float mn_b = fmaxf(m_b, mt_b);
      // a row that sees no key yet keeps p = 0 (and m = -inf)
      const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
      alpha_a = expf(m_a - mu_a);                  // exp(-inf) = 0 on the first hit
      alpha_b = expf(m_b - mu_b);
      float p_a = 0.0f, p_b = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < b_lo || j >= b_hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
          continue;
        }
        sc[j][0] = expf(sc[j][0] - mu_a);
        sc[j][1] = expf(sc[j][1] - mu_a);
        sc[j][2] = expf(sc[j][2] - mu_b);
        sc[j][3] = expf(sc[j][3] - mu_b);
        p_a += sc[j][0];
        p_a += sc[j][1];
        p_b += sc[j][2];
        p_b += sc[j][3];
      }
      l_a = alpha_a * l_a + p_a;
      l_b = alpha_b * l_b + p_b;
      m_a = mn_a;
      m_b = mn_b;
    };

    // O = alpha O + P V over tile t: S's C fragment is P's A fragment with
    // columns t and t + 4 as keys 2t and 2t + 1 (P V's k index permuted),
    // so the B fragment reads V rows 2t and 2t + 1
    auto weigh = [&](int t, const float (&pc)[NB][4]) {
      int b_lo, b_hi;
      blocks(t, b_lo, b_hi);
      const int slot = fill % S;
      mbar_wait(full0 + 8 * slot, (fill / S) & 1);
      if (b_lo < b_hi) {          // else alpha is 1 (or 0 on a zero O)
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][0] *= alpha_a;
          acc[n][1] *= alpha_a;
          acc[n][2] *= alpha_b;
          acc[n][3] *= alpha_b;
        }
        const Elem* v_lane = ring + slot * T::kSlotElems + 2 * tq * RS + g;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (j < b_lo || j >= b_hi) continue;
          uint32_t ph[4], pl[4];
          tc_split(pc[j][0], ph[0], pl[0]);
          tc_split(pc[j][2], ph[1], pl[1]);
          tc_split(pc[j][1], ph[2], pl[2]);
          tc_split(pc[j][3], ph[3], pl[3]);
          const Elem* vj = v_lane + 8 * j * RS;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            uint32_t bh[2], bl[2];
            tc_split(to_f32(vj[8 * n]), bh[0], bl[0]);
            tc_split(to_f32(vj[RS + 8 * n]), bh[1], bl[1]);
            tc_mma3(acc[n], ph, pl, bh, bl);
          }
        }
      }
      mbar_arrive(empty0 + 8 * slot);                // V(t) read
      ++fill;
    };

    float p[NB][4];
    mbar_wait(q_full, round & 1);
    for (int t = t_first; t < t_end; ++t) {
      scores(t, p);
      if (t + 1 == t_end) mbar_arrive(q_empty);      // the item's Q read
      softmax(t, p);
      weigh(t, p);
    }

    // normalize and store: a row's normalizer over its quad
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    if (row_a >= 0) {
      Elem* op = o + static_cast<int64_t>(row_a) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(op + 8 * n, acc[n][0] * inv_a, acc[n][1] * inv_a);
    }
    if (row_b >= 0) {
      Elem* op = o + static_cast<int64_t>(row_b) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(op + 8 * n, acc[n][2] * inv_b, acc[n][3] * inv_b);
    }
  }
}

template <int D, typename Elem>
int tc_smem_bytes() {
  return static_cast<int>(sizeof(float)) * TcShape<D>::kBarFloats
         + static_cast<int>(sizeof(Elem)) * TcShape<D>::kElems;
}

// dynamic shared memory allowed so far, and blocks the card holds at once,
// for flash_fwd_tc_kernel<D, Elem>
template <int D, typename Elem>
int allowed_tc_smem = 0;
template <int D, typename Elem>
int resident_tc_blocks = 0;

template <int D, typename Elem>
int launch_tc(const Elem* q, const Elem* k, const Elem* v, Elem* o,
              int b, int hq, int hkv, int sq, int skv, float scale,
              int causal, int window, cudaStream_t stream) {
  if (!aligned16(q, k, v, o)) return cudaErrorMisalignedAddress;
  // an item holds at most kTcRows / min(Sq, kTcMinPositions) heads; a
  // larger group splits into equal chunks, and positions fill the rows
  // the chunk leaves
  GroupArgs a;
  const int group = hq / hkv;
  const int max_heads = kTcRows / min(sq, kTcMinPositions);
  a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.causal = causal;
  a.window = window; a.scale = scale;
  a.chunks = (group + max_heads - 1) / max_heads;
  a.chunk_heads = (group + a.chunks - 1) / a.chunks;
  a.positions = kTcRows / a.chunk_heads;
  a.n_tiles = (sq + a.positions - 1) / a.positions;
  const int64_t items = static_cast<int64_t>(a.n_tiles) * b * hkv * a.chunks;
  if (items > 0x7fffffff || static_cast<int64_t>(b) * hq * sq > 0x7fffffff)
    return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  const int smem = tc_smem_bytes<D, Elem>();
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D, Elem>, smem,
                               &allowed_tc_smem<D, Elem>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = resident_blocks(flash_fwd_tc_kernel<D, Elem>, kTcThreads, smem,
                        &resident_tc_blocks<D, Elem>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min(a.n_items, resident_tc_blocks<D, Elem>);
  flash_fwd_tc_kernel<D, Elem><<<blocks, kTcThreads, smem, stream>>>(q, k, v, o, a);
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
    case 96: return launch_tc<96>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 128: return launch_tc<128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 192: return launch_tc<192>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 256: return launch_group<256>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// The same on bf16 q, k, v and o (f32 inside, the output rounded to
// nearest even), at head_dim 16, 32, 64 and 128.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int hq,
                                    int hkv, int sq, int skv, int d,
                                    float scale, int causal, int window,
                                    void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sq > skv) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  switch (d) {
    case 16: return launch_small<16>(qb, kb, vb, ob, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 32: return launch_small<32>(qb, kb, vb, ob, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 64: return launch_small<64>(qb, kb, vb, ob, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 128: return launch_tc<128>(qb, kb, vb, ob, b, hq, hkv, sq, skv, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// the head_dim-d kernel as built, on the current device
// (flash_fwd_small_kernel<d> at 16, 32 and 64, flash_fwd_tc_kernel<d> at 96,
// 128 and 192, flash_fwd_group_kernel<d> at 256): eight ints into
// info[8] -- registers and local memory bytes per thread, static and
// dynamic shared memory bytes per block, resident blocks per SM, threads a
// block, query rows a block ((head, position) rows an item for the tc and
// group kernels), keys a K/V tile.
template <int D, typename Elem>
int small_attributes(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, flash_fwd_small_kernel<D, Elem>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_small_kernel<D, Elem>, kSmallThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes);
  info[3] = 0;
  info[4] = blocks;
  info[5] = kSmallThreads;
  info[6] = kSmallRows;
  info[7] = kSmallBK;
  return 0;
}

template <int D>
int group_attributes(int* info) {
  const int smem = group_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_group_kernel<D>, smem,
                               &allowed_group_smem<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, flash_fwd_group_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_group_kernel<D>, kGThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes);
  info[3] = smem;
  info[4] = blocks;
  info[5] = kGThreads;
  info[6] = kGRows;
  info[7] = kGBK;
  return 0;
}

template <int D, typename Elem>
int tc_attributes(int* info) {
  const int smem = tc_smem_bytes<D, Elem>();
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D, Elem>, smem,
                               &allowed_tc_smem<D, Elem>);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, flash_fwd_tc_kernel<D, Elem>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_tc_kernel<D, Elem>, kTcThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes);
  info[3] = smem;
  info[4] = blocks;
  info[5] = kTcThreads;
  info[6] = kTcRows;
  info[7] = kTcBK;
  return 0;
}

extern "C" int flash_attention_attributes(int d, int* info) {
  switch (d) {
    case 16: return small_attributes<16, float>(info);
    case 32: return small_attributes<32, float>(info);
    case 64: return small_attributes<64, float>(info);
    case 96: return tc_attributes<96, float>(info);
    case 128: return tc_attributes<128, float>(info);
    case 192: return tc_attributes<192, float>(info);
    case 256: return group_attributes<256>(info);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 instance at head_dim d (16, 32, 64: flash_fwd_small_kernel<d,
// bf16>; 128: flash_fwd_tc_kernel<128, bf16>), the same eight ints.
extern "C" int flash_attention_bf16_attributes(int d, int* info) {
  switch (d) {
    case 16: return small_attributes<16, bf16>(info);
    case 32: return small_attributes<32, bf16>(info);
    case 64: return small_attributes<64, bf16>(info);
    case 128: return tc_attributes<128, bf16>(info);
    default: return cudaErrorInvalidValue;
  }
}
