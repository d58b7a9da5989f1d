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
// [40,1,64,256], causal, window 2048) has its own kernel,
// flash_fwd_group_kernel, a template on D (128 would be one more
// instantiation). Bound at that shape: bytes, 57.7 MB of q/k/v/out, at least
// 17.2 us at 3.35 TB/s; the 0.85 GFLOP of the visible pairs need 12.7 us of
// f32 FMA at 67 TFLOP/s. The two bounds are close, so the copies have to
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


// head_dim >= 128: blocks of kGRows (head, position) rows of one kv head
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
  static constexpr int kCG = kGThreads / kRG;               // column groups
  static constexpr int kPC = kD4 / kCG;                     // float4 a thread
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
  static_assert(kRG * kCG == kGThreads && kD4 % kCG == 0 && kCG >= 8,
                "P V tile must cover the block's threads");
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
  // P V coordinates: rows pr + kRG i, float4 columns cg + kCG c
  const int cg = tid % G::kCG;
  const int pr = tid / G::kCG;

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

  float4 acc[RT][G::kPC];
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
      for (int i = 0; i < RT; ++i)
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
    {
      const int j_lo = max(0, cur.k_begin - k0) & ~3;
      const int j_hi = min(kGBK, cur.k_end - k0);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float al = alpha_s[pr + i * G::kRG];
#pragma unroll
        for (int c = 0; c < G::kPC; ++c) {
          acc[i][c].x *= al; acc[i][c].y *= al; acc[i][c].z *= al; acc[i][c].w *= al;
        }
      }
      const float* pt = ss + pr * G::kSStride;
      const float* vt = ring + ((pos + 1) % kGSlots) * kGBK * D + 4 * cg;
#pragma unroll 1
      for (int j = j_lo; j < j_hi; j += 4) {
        float4 p[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          p[i] = *reinterpret_cast<const float4*>(pt + i * G::kRG * G::kSStride + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 vv[G::kPC];
#pragma unroll
          for (int c = 0; c < G::kPC; ++c)
            vv[c] = *reinterpret_cast<const float4*>(vt + (j + jj) * D + 4 * G::kCG * c);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
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
      for (int i = 0; i < RT; ++i) {
        const int r = pr + i * G::kRG;
        const int64_t row = group_row(a, cur, r);
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
    case 256: return launch_group<256>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// flash_fwd_group_kernel<d> as built, on the current device: eight ints
// into info[8] -- registers and local memory bytes per thread, static and
// dynamic shared memory bytes per block, resident blocks per SM, threads a
// block, (head, position) rows a block, keys a K/V tile.
extern "C" int flash_attention_attributes(int d, int* info) {
  if (d != 256) return cudaErrorInvalidValue;
  const int smem = group_smem_bytes<256>();
  cudaError_t err = allow_smem(flash_fwd_group_kernel<256>, smem,
                               &allowed_group_smem<256>);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, flash_fwd_group_kernel<256>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_group_kernel<256>, kGThreads, smem);
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
