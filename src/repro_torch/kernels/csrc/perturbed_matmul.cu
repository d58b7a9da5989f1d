// Fused perturbed matmul for Hopper (sm_90a): out = x @ (w + eps * z(seed)).
//
// Replaces the TPU kernel repro/kernels/perturbed_matmul.py:
// perturbed_matmul_pallas (body _pmm_kernel). Element (k, n) of w draws the
// counter off + k * N + n (uint32, wrapping) over the UNPADDED w, from the
// counter-hash stream of counter_hash.cuh: the perturbed weights never
// exist in device memory, only a few (BK x BN) tiles of them in shared
// memory.
//
// Shapes: x [M, K] and w [K, N], row-major f32; out [M, N] f32. The main
// path (full OPT-125M, 5 clients x 8 rows x 64 tokens) has M = 2560 and
// (K, N) in {(768, 768), (768, 3072), (3072, 768)}.
//
// Bound on the H100: f32 operations. 2*M*K*N flops (12.1 GFLOP at
// 2560 x 768 x 3072) need at least 0.18 ms at 67 TFLOP/s, while the bytes
// (x, w and out once each, 17 MB there) need 5 us. The products stay plain
// f32 FMA on the CUDA cores -- no TF32 and no tensor cores -- for parity
// with cuBLAS SGEMM and with the plain version, and because the identity
// probe (x = I returns exactly what seeded_axpy writes) is bitwise.
//
// Design. Each block owns a BM x BN = 128 x 128 output tile; its 256
// threads each accumulate an 8 x 8 register micro-tile while the block
// walks K in steps of BK = 16 (the loop replaces the TPU grid's sequential
// k axis). Drawing z costs about as much as the FMAs it feeds (two fmix32,
// a precise logf, sqrtf and cosf per weight), and a block that drew its
// own tiles would redraw every weight M / BM times. So the blocks that
// share w columns are grouped into a thread-block cluster of C blocks
// stacked along M, and the perturbed tile is drawn once per cluster:
//   - each block loads and draws BK / C rows of the (BK x BN) tile of
//     w + eps * z and stores them into the shared memory of every block
//     of the cluster (st.shared::cluster, distributed shared memory), so
//     z is drawn M / (BM * C) times per weight (5 at M = 2560, C = 4;
//     C = 4 ran faster than 2, which draws twice as often, and than 8,
//     which pads the grid, on the H100);
//   - the perturbed tiles sit in a ring of three stages and the x tiles,
//     brought in by cp.async, in a ring of four, so that step s draws and
//     distributes tile s + 1 and starts the copy of x tile s + 2 before it
//     multiplies tile s: no thread waits on a global load before its FMAs;
//   - one cluster barrier per step, split into arrive (release) and wait
//     (acquire) around the product, orders it all: after the wait of step
//     s every block has written tile s, landed its x tile s, and finished
//     the product of step s - 2, whose stages step s refills. The barrier's
//     latency hides behind the product.
// The grid's M dimension is rounded up to a multiple of C; a block whose
// rows all lie past M still draws its share and keeps every barrier, and
// skips only its FMAs and stores. Ragged K/N edges are masked: x columns
// past K are zero-filled by the copy, w rows and columns past K/N are zero.
// w + eps*z is formed once per element with __fmul_rn / __fadd_rn and
// never contracted into the product. Two 256-thread blocks share an SM at
// up to 128 registers a thread. Later work: wgmma tiles once a parity
// tolerance is agreed, producer warps kept two stages ahead on per-stage
// cluster mbarriers, and a dual-eps variant that draws z once for both
// rollouts.
//
// bf16 x and w (perturbed_matmul_bf16) run on the tensor cores: see
// pmm_kernel_bf16 below. pmm_kernel is instantiated on f32 alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int kThreads = 256;
constexpr int kCluster = 4;     // blocks per cluster along M: C above
constexpr int kXStages = 4;     // x tile s + 2 is copied while s is multiplied
constexpr int kWStages = 3;     // w + eps z tile s + 1 is drawn while s is multiplied
// xs[m][k]: 80-byte rows keep each row 16-byte aligned for cp.async and put
// the two row groups of a warp (4 rows apart) on different banks
constexpr int LDX = BK + 4;
constexpr int LDW = BN + 4;

using bf16 = __nv_bfloat16;

// x stages (in x's element type), then the f32 w + eps z stages: 66,304
// bytes
template <typename Elem>
constexpr size_t smem_bytes() {
  return sizeof(Elem) * kXStages * BM * LDX + sizeof(float) * kWStages * BK * LDW;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; src_bytes < size fills
// the rest with zeros (0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// this block's shared address addr, seen in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads, 2)
pmm_kernel(const Elem* __restrict__ x, const Elem* __restrict__ w,
           Elem* __restrict__ out, int M, int K, int N,
           const uint32_t* __restrict__ seed_ptr, uint32_t off,
           const float* __restrict__ eps_ptr, int x_vec, int out_vec) {
  constexpr int kRows = BK / kCluster;            // w tile rows this block draws
  constexpr int kDraws = kRows * BN / kThreads;   // per thread: 2
  constexpr uint32_t kEB = sizeof(Elem);          // bytes an x element
  static_assert(BK % kCluster == 0 && kDraws >= 1, "cluster size must divide BK");
  extern __shared__ __align__(16) float smem[];
  Elem* xs = reinterpret_cast<Elem*>(smem);       // [kXStages][BM][LDX]
  float* ws = reinterpret_cast<float*>(xs + kXStages * BM * LDX);  // [kWStages][BK][LDW]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const uint32_t rank = cluster_rank();
  // The seed stays in a register through the kernel and eps is read (from
  // L1) at each draw, where the hash hides the load: with both held through
  // the product the accumulators spill at 128 registers, and a seed read at
  // each draw puts the load in front of the hash (1.4% slower on the H100)
  const uint32_t seed_mix = *seed_ptr * counter_hash::kGolden;
  const int nk = (K + BK - 1) / BK;
  const bool live = m0 < M;

  // This block's share of each w tile: rows rank * kRows + tid / BN + 2d
  // (d < kDraws), column tid % BN; a warp reads 128 contiguous bytes.
  const int wc = tid % BN;
  const int wr = static_cast<int>(rank) * kRows + tid / BN;
  const int gn = n0 + wc;
  float wv[kDraws];
  auto fetch_w = [&](int s) {
#pragma unroll
    for (int d = 0; d < kDraws; ++d) {
      const int gk = s * BK + wr + 2 * d;
      wv[d] = (gk < K && gn < N) ? to_f32(w[static_cast<int64_t>(gk) * N + gn]) : 0.0f;
    }
  };
  // the same shared-memory word in every block of the cluster
  const uint32_t ws_local = smem_u32(ws + wr * LDW + wc);
  uint32_t ws_peer[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) ws_peer[p] = map_rank(ws_local, p);
  auto put_w = [&](int s) {
    const float eps = __ldg(eps_ptr);
    const uint32_t stage = 4u * static_cast<uint32_t>((s % kWStages) * BK * LDW);
#pragma unroll
    for (int d = 0; d < kDraws; ++d) {
      const int gk = s * BK + wr + 2 * d;
      float v = 0.0f;
      if (gk < K && gn < N) {
        const uint32_t ctr = off + static_cast<uint32_t>(gk) *
                                       static_cast<uint32_t>(N) +
                             static_cast<uint32_t>(gn);
        v = counter_hash::axpy(wv[d], eps, ctr, seed_mix);
      }
      const uint32_t at = stage + 4u * static_cast<uint32_t>(2 * d * LDW);
#pragma unroll
      for (int p = 0; p < kCluster; ++p) st_cluster(ws_peer[p] + at, v);
    }
  };

  // x tile: 128 rows x 16 columns = 512 chunks of 4 elements (16 bytes in
  // f32, 8 in bf16), two per thread; four neighbouring threads copy one
  // row's 16 contiguous elements.
  const int xr = tid / 4;                         // rows xr and xr + 64
  const int xc = (tid % 4) * 4;
  const uint32_t xs_base = smem_u32(xs + xr * LDX + xc);
  auto fetch_x = [&](int s) {
    const uint32_t stage = kEB * static_cast<uint32_t>((s % kXStages) * BM * LDX);
    const int gk = s * BK + xc;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int gm = m0 + xr + it * 64;
      const uint32_t dst = xs_base + stage + kEB * static_cast<uint32_t>(it * 64 * LDX);
      const Elem* src = x + static_cast<int64_t>(gm) * K + gk;
      if (x_vec) {            // K % 4 == 0: a chunk lies wholly inside or past K
        const bool ok = gm < M && gk < K;
        if (kEB == 4) cp_async16(dst, ok ? src : x, ok ? 16 : 0);
        else cp_async8(dst, ok ? src : x, ok ? 8 : 0);
      } else if (kEB == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gm < M && gk + e < K;
          cp_async4(dst + 4u * e, ok ? src + e : x, ok ? 4 : 0);
        }
      } else {
        // a ragged bf16 row: element by element, through registers (the
        // cluster barrier before the product orders these stores too)
        Elem* d = xs + (s % kXStages) * BM * LDX + (xr + it * 64) * LDX + xc;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gm < M && gk + e < K;
          d[e] = ok ? src[e] : Elem(0.0f);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // prologue: x tiles 0 and 1 in flight, w tile 0 drawn and distributed
  if (nk > 0) fetch_w(0);
  if (nk > 0) fetch_x(0);
  cp_async_commit();
  if (nk > 1) fetch_x(1);
  cp_async_commit();
  // every block of the cluster runs before any writes into its shared memory
  cluster_arrive();
  cluster_wait();
  if (nk > 0) put_w(0);
  if (nk > 1) fetch_w(1);
  cp_async_wait<1>();                             // x tile 0 has landed
  cluster_arrive();

  for (int s = 0; s < nk; ++s) {
    // tile s of w + eps z and of x is in place in every block, and every
    // block is done multiplying tile s - 2, whose stages are refilled here
    cluster_wait();
    if (s + 1 < nk) put_w(s + 1);
    if (s + 2 < nk) {
      fetch_w(s + 2);
      fetch_x(s + 2);
    }
    cp_async_commit();                            // one group per step, maybe empty
    cp_async_wait<1>();                           // x tile s + 1 has landed
    cluster_arrive();

    if (live) {
      const Elem* xt = xs + (s % kXStages) * BM * LDX;
      const float* wt = ws + (s % kWStages) * BK * LDW;
      // rows {ty*4 + i, 64 + ty*4 + i}, columns {tx*4 + j, 64 + tx*4 + j}
#pragma unroll
      for (int k = 0; k < BK; k += 2) {
        float2 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
          a[i] = load2(&xt[r * LDX + k]);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float4 b0 = *reinterpret_cast<const float4*>(&wt[(k + kk) * LDW + tx * 4]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&wt[(k + kk) * LDW + 64 + tx * 4]);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = kk == 0 ? a[i].x : a[i].y;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
          }
        }
      }
    }
  }
  // the last arrive is matched before the block exits; no block writes
  // into a peer's shared memory after the wait of the last step
  cluster_wait();
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
    Elem* row = out + static_cast<int64_t>(gm) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = n0 + h * 64 + tx * 4;
      if (out_vec && gc + 4 <= N) {
        store4(row + gc, acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
               acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < N) store1(row + gc + e, acc[i][h * 4 + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x and w (perturbed_matmul_bf16) on the tensor cores.
//
// The same function as the TPU kernel on bf16 operands: x and w are read in
// f32, v = w + eps * z is formed in f32 (__fmul_rn / __fadd_rn, never
// rounded to bf16 and never contracted), the sums are f32 and each output
// is rounded once to bf16, to nearest even. x is exact in bf16, and v splits
// into three bf16 pieces whose sum is v (bf16_split3); the product of a bf16
// x with a bf16 piece is exact in f32, so three bf16 tensor-core products
// into one f32 accumulator (bf16_mma3: x.lo, x.mid, x.hi) carry v's whole
// 24 bits, as the flash kernels' 3xTF32 does at 96/128/192. The identity
// probe (x = I) accumulates exactly v and rounds it once: what
// seeded_axpy_bf16 writes, bitwise.
//
// Bound on the H100 at one OPT-125M layer's 7 projections (M = 2560): the
// three products are 3 x 2*M*K*N = 145 GFLOP, at least 0.1466 ms at the
// 989 TFLOP/s of bf16; the bytes (109 MB) need 0.033 ms and one draw of each
// of the 9.44 M weights about 0.03 ms of issue. A weight is drawn
// M / (BM * C) times, and a draw (two fmix32, a precise logf, sqrtf and
// cosf: about 106 SASS instructions in seeded_axpy_bf16) costs issue
// slots beside the products it feeds.
//
// Design. A block owns kTcBM x kTcBN = 128 x 64 outputs with 8 warps of
// 32 x 32 outputs, each 2 x 4 tiles of mma.sync m16n8k16 with f32
// accumulators (A from the x tile by ldmatrix, each piece's B by
// ldmatrix.trans), and walks K in steps of kTcBK = 32, two k16 products a
// step. As in the f32 kernel the blocks that share w columns form a
// cluster of kTcCluster blocks stacked along M and the perturbed tile is
// drawn once per cluster: each block draws kTcBK / C rows of the tile, a
// thread kTcDrawCols adjacent columns of a row (one load of w), splits
// each weight and stores each piece's bytes into the shared memory of
// every block of the cluster (st.shared::cluster); z is never stored in
// device memory. x tiles arrive by cp.async (16 bytes where K % 8 == 0, 8
// where K % 4 == 0, else element by element through registers) into
// 80-byte rows, which ldmatrix reads without bank conflicts. A tile's
// pieces sit in [3][kTcBK][kTcBN] bf16 (lo, mid, hi), the 16-byte chunks
// of each row XOR-swizzled by the row, so that ldmatrix.trans reads B
// without bank conflicts. Rings of four stages and one cluster barrier a
// step order it all: after the wait of step s every block has drawn and
// stored tile s, landed its x tile s, and finished multiplying tile
// s - 2, whose stages step s refills with tile s + 2 while it multiplies
// tile s; the arrive follows the wait at once, so that the barrier's round
// trip runs under the step's draws and products. Two blocks share an SM.
// No atomics and no split-K: a call repeats bitwise.
//
// On the H100 one OPT-125M layer's 7 projections take 0.80-0.84 ms, 17-18%
// of the bound (chip_smoke.py; chip_pmm_variants.py also times 128-wide
// blocks, 64 x 32 warp tiles, 64-deep steps, clusters of 8 and 2 draws a
// weight at BM 160 against it). No one part sets that time: without the
// draws or without the products it still takes about 0.68 ms, without
// both 0.56; its barriers and ldmatrix reads alone take 0.33 and the
// ldmatrix reads without the barriers 0.09, so a step's cluster barrier
// costs about 0.6 us wherever no work hides it.
// Later work: wgmma (bf16 takes an MN-major B from shared memory, so the
// row-major pieces need no transpose, and reads it without register
// fragments), then one draw of z for both rollouts.

constexpr int kTcBM = 128;        // output rows a block
constexpr int kTcCluster = 4;     // blocks a cluster along M
constexpr int kTcBN = 64;         // output columns a block
constexpr int kTcBK = 32;         // K a step: two m16n8k16 products
constexpr int kTcWM = 32;         // output rows a warp (its columns: 32)
constexpr int kTcMI = kTcWM / 16; // m16 tiles a warp
constexpr int kTcWarpsN = kTcBN / 32;
constexpr int kTcThreads = 32 * (kTcBM / kTcWM) * kTcWarpsN;
constexpr int kTcMinBlocks = 2;   // blocks an SM (the registers a thread follow)
// tiles s + 2 are drawn and copied while s is multiplied, and a block may
// still multiply s - 1 then
constexpr int kTcXStages = 4;
constexpr int kTcWStages = 4;
constexpr int kTcLDX = kTcBK + 8; // x rows 16 bytes longer than the tile's
constexpr int kTcRows = kTcBK / kTcCluster;          // tile rows a block draws a step
// the threads that draw: the first warps, as many as take two columns each
constexpr int kTcDrawers =
    kTcThreads < kTcRows * kTcBN / 2 ? kTcThreads : kTcRows * kTcBN / 2;
// adjacent columns a drawer takes: 8, 4 or 2 (16-, 8- or 4-byte loads and
// stores), as many as the block's share of a tile holds a drawer
constexpr int kTcDrawCols = kTcRows * kTcBN >= 8 * kTcDrawers   ? 8
                            : kTcRows * kTcBN >= 4 * kTcDrawers ? 4
                                                                : 2;
constexpr int kTcRowsAPass = kTcDrawers / (kTcBN / kTcDrawCols);
constexpr int kTcDrawRows = kTcRows / kTcRowsAPass;     // rows a drawer takes a step
constexpr uint32_t kTcXStage = 2u * kTcBM * kTcLDX;      // bytes
constexpr uint32_t kTcPiece = 2u * kTcBK * kTcBN;        // bytes of one piece's tile
constexpr uint32_t kTcWStage = 3u * kTcPiece;
constexpr size_t kTcSmem = kTcXStages * kTcXStage + kTcWStages * kTcWStage;
static_assert(kTcBM % kTcWM == 0 && kTcBN % 32 == 0 && kTcWM % 16 == 0,
              "whole warps of kTcWM x 32 outputs");
static_assert(kTcBK % kTcCluster == 0 && kTcBK % 16 == 0, "cluster size must divide BK");
static_assert(kTcRowsAPass >= 1 && kTcRows % kTcRowsAPass == 0 && kTcDrawers % 32 == 0,
              "whole warps of drawers take whole rows of the block's share");

__device__ __forceinline__ uint32_t bf16_bits(bf16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}
__device__ __forceinline__ float bf16_value(bf16 v) { return __bfloat162float(v); }

// v = hi + mid + lo for the two weights a and b, each piece packed two to a
// word (a in the low half): piece[0] lo, piece[1] mid, piece[2] hi. hi is v
// rounded to bf16 to nearest even; mid and lo the remainders rounded toward
// zero, each subtraction exact in f32. Where v's lowest set bit is at or
// above 2^-133 (bf16's smallest subnormal: every |v| >= 2^-110) the three
// pieces carry v exactly: hi takes its top 8 significant bits, mid the next
// 8 and lo the last 8. Below that they cannot, and rounding mid and lo toward
// zero keeps hi + mid + lo between hi and v, so that it still rounds to hi:
// the identity probe holds for every finite |v| below bf16's largest value.
__device__ __forceinline__ void bf16_split3(float a, float b, uint32_t (&piece)[3]) {
  const bf16 hi_a = __float2bfloat16_rn(a);
  const bf16 hi_b = __float2bfloat16_rn(b);
  const float ra = __fsub_rn(a, bf16_value(hi_a));
  const float rb = __fsub_rn(b, bf16_value(hi_b));
  const bf16 mid_a = __float2bfloat16_rz(ra);
  const bf16 mid_b = __float2bfloat16_rz(rb);
  const bf16 lo_a = __float2bfloat16_rz(__fsub_rn(ra, bf16_value(mid_a)));
  const bf16 lo_b = __float2bfloat16_rz(__fsub_rn(rb, bf16_value(mid_b)));
  piece[0] = bf16_bits(lo_a) | (bf16_bits(lo_b) << 16);
  piece[1] = bf16_bits(mid_a) | (bf16_bits(mid_b) << 16);
  piece[2] = bf16_bits(hi_a) | (bf16_bits(hi_b) << 16);
}

// c[i] += x_i v on the tensor cores for T m16n8k16 tiles that share one n8
// column block, v in three bf16 pieces: x.lo, x.mid, then x.hi into each
// f32 accumulator, small terms first, each pass over all T tiles so that
// the products that wait on one another lie T apart. a[i] is tile i's A
// fragment (rows g, g+8; columns 2t, 2t+1 and 2t+8, 2t+9) of lane 4 g + t,
// each b the B fragment (rows 2t, 2t+1 and 2t+8, 2t+9; column g); c[i]
// rows g, g+8, columns 2t, 2t+1.
template <int T>
__device__ __forceinline__ void bf16_mma3(float (&c)[T][4], const uint32_t (&a)[T][4],
                                          const uint32_t (&blo)[2],
                                          const uint32_t (&bmid)[2],
                                          const uint32_t (&bhi)[2]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
        : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(blo[0]),
          "r"(blo[1]));
#pragma unroll
  for (int i = 0; i < T; ++i)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
        : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(bmid[0]),
          "r"(bmid[1]));
#pragma unroll
  for (int i = 0; i < T; ++i)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
        : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(bhi[0]),
          "r"(bhi[1]));
}

// four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (transposed: each lane gets a column pair)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the byte offset of element (row, col) in one piece's [kTcBK][kTcBN] tile:
// rows of 16-byte chunks, chunk c of row r stored at c ^ (r % 8), so that
// the 8 rows an ldmatrix reads lie on 8 bank groups
__device__ __forceinline__ uint32_t tc_swizzle(int row, int col) {
  return static_cast<uint32_t>(row * 2 * kTcBN + (((col >> 3) ^ (row & 7)) << 4) +
                               (col & 7) * 2);
}

// 4, 8 or 16 bytes (n = 1, 2 or 4 words) into shared memory at a cluster
// address
template <int n>
__device__ __forceinline__ void st_cluster_vec(uint32_t addr, const uint32_t (&v)[n]) {
  static_assert(n == 1 || n == 2 || n == 4, "4, 8 or 16 bytes");
  if constexpr (n == 1) {
    asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v[0]) : "memory");
  } else if constexpr (n == 4) {
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  } else {
    asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v[0]),
                 "r"(v[1])
                 : "memory");
  }
}
// n words (2n bf16) from global memory, 4n-byte aligned
template <int n>
__device__ __forceinline__ void load_words(const uint16_t* src, uint32_t (&v)[n]) {
  if constexpr (n == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else if constexpr (n == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = *reinterpret_cast<const uint32_t*>(src);
  }
}

// x_mode: 2 copies x by 16 bytes (K % 8 == 0, 16-byte aligned base), 1 by 8
// (K % 4 == 0, 8-byte aligned), 0 element by element; w_vec: w's rows hold
// whole 16-byte aligned groups of 8; out_vec: out's rows whole aligned pairs
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
pmm_kernel_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                bf16* __restrict__ out, int M, int K, int N,
                const uint32_t* __restrict__ seed_ptr, uint32_t off,
                const float* __restrict__ eps_ptr, int x_mode, int w_vec,
                int out_vec) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t xs0 = smem_u32(tc_smem);                 // [kTcXStages][BM][kTcLDX]
  const uint32_t ws0 = xs0 + kTcXStages * kTcXStage;      // [kTcWStages][3][BK][BN]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool drawer = tid < kTcDrawers;
  const int m0 = blockIdx.y * kTcBM;
  const int n0 = blockIdx.x * kTcBN;
  const uint32_t rank = cluster_rank();
  const int nk = (K + kTcBK - 1) / kTcBK;
  const bool live = m0 < M;

  // ---- the drawers' share of each tile of v: rows rank * kTcRows + dr +
  // r * kTcRowsAPass (r < kTcDrawRows) of the tile, columns dc .. dc + 7;
  // a warp reads two or more whole 256-byte rows of w
  const int dr = static_cast<int>(rank) * kTcRows + tid / (kTcBN / kTcDrawCols);
  const int dc = (tid % (kTcBN / kTcDrawCols)) * kTcDrawCols;
  const int gn = n0 + dc;
  // the seed in a register, eps read (from L1) at each draw, as in pmm_kernel
  const uint32_t seed_mix = drawer ? *seed_ptr * counter_hash::kGolden : 0u;
  uint32_t wv[kTcDrawRows][kTcDrawCols / 2];      // w's bf16 bits, two a word
  auto fetch_w = [&](int s) {
#pragma unroll
    for (int r = 0; r < kTcDrawRows; ++r) {
      const int gk = s * kTcBK + dr + r * kTcRowsAPass;
      const uint16_t* src = w + static_cast<int64_t>(gk) * N + gn;
      if (w_vec && gk < K && gn + kTcDrawCols <= N) {
        load_words(src, wv[r]);
      } else {
#pragma unroll
        for (int j = 0; j < kTcDrawCols / 2; ++j) {
          const uint32_t e0 = (gk < K && gn + 2 * j < N) ? src[2 * j] : 0u;
          const uint32_t e1 = (gk < K && gn + 2 * j + 1 < N) ? src[2 * j + 1] : 0u;
          wv[r][j] = e0 | (e1 << 16);
        }
      }
    }
  };
  auto put_w = [&](int s) {
    const float eps = __ldg(eps_ptr);
    const uint32_t stage = static_cast<uint32_t>(s % kTcWStages) * kTcWStage;
#pragma unroll
    for (int r = 0; r < kTcDrawRows; ++r) {
      const int row = dr + r * kTcRowsAPass;
      const int gk = s * kTcBK + row;
      uint32_t piece[3][kTcDrawCols / 2];
#pragma unroll
      for (int j = 0; j < kTcDrawCols / 2; ++j) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * j + h;
          v[h] = 0.0f;
          if (gk < K && gn + c < N) {
            const uint32_t ctr = off + static_cast<uint32_t>(gk) *
                                           static_cast<uint32_t>(N) +
                                 static_cast<uint32_t>(gn + c);
            const float wf =
                __uint_as_float(h ? (wv[r][j] & 0xffff0000u) : (wv[r][j] << 16));
            v[h] = counter_hash::axpy(wf, eps, ctr, seed_mix);
          }
        }
        uint32_t p3[3];
        bf16_split3(v[0], v[1], p3);
#pragma unroll
        for (int q = 0; q < 3; ++q) piece[q][j] = p3[q];
      }
      // these 8 or 16 bytes of each piece, in every block of the cluster
      const uint32_t local = ws0 + stage + tc_swizzle(row, dc);
#pragma unroll
      for (int p = 0; p < kTcCluster; ++p) {
#pragma unroll
        for (int q = 0; q < 3; ++q) st_cluster_vec(map_rank(local + q * kTcPiece, p), piece[q]);
      }
    }
  };
  // x tile: kTcBM rows x kTcBK columns, by 16- or 8-byte chunks or
  // elements; consecutive drawers take consecutive chunks of a row
  auto fetch_x = [&](int s) {
    const uint32_t stage = xs0 + static_cast<uint32_t>(s % kTcXStages) * kTcXStage;
    const int k0 = s * kTcBK;
    if (x_mode == 2) {
#pragma unroll
      for (int i = 0; i < kTcBM * kTcBK / 8 / kTcDrawers; ++i) {
        const int c = tid + i * kTcDrawers;
        const int r = c / (kTcBK / 8);
        const int col = (c % (kTcBK / 8)) * 8;
        const int gm = m0 + r;
        const int gk = k0 + col;
        const bool ok = gm < M && gk < K;
        cp_async16(stage + 2u * static_cast<uint32_t>(r * kTcLDX + col),
                   ok ? x + static_cast<int64_t>(gm) * K + gk : x, ok ? 16 : 0);
      }
    } else if (x_mode == 1) {
#pragma unroll 4
      for (int i = 0; i < kTcBM * kTcBK / 4 / kTcDrawers; ++i) {
        const int c = tid + i * kTcDrawers;
        const int r = c / (kTcBK / 4);
        const int col = (c % (kTcBK / 4)) * 4;
        const int gm = m0 + r;
        const int gk = k0 + col;
        const bool ok = gm < M && gk < K;
        cp_async8(stage + 2u * static_cast<uint32_t>(r * kTcLDX + col),
                  ok ? x + static_cast<int64_t>(gm) * K + gk : x, ok ? 8 : 0);
      }
    } else {
      // a ragged row: element by element, through registers (the cluster
      // barrier before the product orders these stores too)
      uint16_t* xs = reinterpret_cast<uint16_t*>(tc_smem) +
                     (s % kTcXStages) * kTcBM * kTcLDX;
#pragma unroll 4
      for (int i = 0; i < kTcBM * kTcBK / kTcDrawers; ++i) {
        const int c = tid + i * kTcDrawers;
        const int r = c / kTcBK;
        const int col = c % kTcBK;
        const int gm = m0 + r;
        const int gk = k0 + col;
        xs[r * kTcLDX + col] =
            (gm < M && gk < K) ? x[static_cast<int64_t>(gm) * K + gk] : uint16_t(0);
      }
    }
  };

  // ---- the mma warps: rows wm * kTcWM .. + kTcWM, columns wn * 32 .. + 32.
  // ldmatrix rows: A rows wm * kTcWM + 16 mi + lane % 16 at columns
  // 8 (lane / 16); B (a piece) rows 8 ((lane / 8) % 2) + lane % 8 at
  // columns wn * 32 + 16 np + 8 (lane / 16)
  const int wm = warp / kTcWarpsN;
  const int wn = warp % kTcWarpsN;
  const uint32_t a_off = 2u * static_cast<uint32_t>((wm * kTcWM + lane % 16) * kTcLDX +
                                                    (lane / 16) * 8);
  uint32_t b_off[2];
#pragma unroll
  for (int np = 0; np < 2; ++np)
    b_off[np] = tc_swizzle(((lane >> 3) & 1) * 8 + (lane & 7),
                           wn * 32 + np * 16 + (lane >> 4) * 8);
  float acc[4][kTcMI][4];                         // [n8 tile][m16 tile]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kTcMI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // prologue: x tiles 0 and 1 in flight, w tiles 0 and 1 drawn and
  // distributed
  if (drawer) {
    if (nk > 0) fetch_w(0);
    if (nk > 0) fetch_x(0);
    cp_async_commit();
    if (nk > 1) fetch_x(1);
    cp_async_commit();
  }
  // every block of the cluster runs before any writes into its shared memory
  cluster_arrive();
  cluster_wait();
  if (drawer) {
    if (nk > 0) put_w(0);
    if (nk > 1) {
      fetch_w(1);
      put_w(1);
    }
    if (nk > 2) fetch_w(2);
    cp_async_wait<1>();                           // x tile 0 has landed
  }
  cluster_arrive();

  for (int s = 0; s < nk; ++s) {
    // every block has drawn tile s and landed its x tile s, and is done
    // multiplying tile s - 2, whose stages are refilled here. The arrive
    // follows at once, so that the barrier's round trip runs under this
    // step's draws and products
    cluster_wait();
    if (drawer) cp_async_wait<0>();               // x tile s + 1 has landed
    cluster_arrive();
    if (drawer) {
      if (s + 2 < nk) {
        put_w(s + 2);
        fetch_x(s + 2);
      }
      if (s + 3 < nk) fetch_w(s + 3);
      cp_async_commit();                          // one group per step, maybe empty
    }
    if (live) {
      const uint32_t xt = xs0 + static_cast<uint32_t>(s % kTcXStages) * kTcXStage + a_off;
      const uint32_t wt = ws0 + static_cast<uint32_t>(s % kTcWStages) * kTcWStage;
#pragma unroll
      for (int kk = 0; kk < kTcBK; kk += 16) {
        uint32_t a[kTcMI][4];
#pragma unroll
        for (int mi = 0; mi < kTcMI; ++mi)
          ldsm_x4(a[mi], xt + 2u * static_cast<uint32_t>(mi * 16 * kTcLDX + kk));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[3][4];                         // lo, mid, hi: two n8 tiles each
#pragma unroll
          for (int q = 0; q < 3; ++q)
            ldsm_x4_trans(b[q], wt + q * kTcPiece + b_off[np] +
                                    static_cast<uint32_t>(kk * 2 * kTcBN));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t lo[2] = {b[0][2 * j], b[0][2 * j + 1]};
            const uint32_t mid[2] = {b[1][2 * j], b[1][2 * j + 1]};
            const uint32_t hi[2] = {b[2][2 * j], b[2][2 * j + 1]};
            bf16_mma3(acc[np * 2 + j], a, lo, mid, hi);
          }
        }
      }
    }
  }
  // the last arrive is matched before the block exits; no block writes
  // into a peer's shared memory after the last step's wait
  cluster_wait();
  if (!live) return;

  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < kTcMI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm * kTcWM + mi * 16 + g + 8 * half;
      if (gm >= M) continue;
      bf16* row = out + static_cast<int64_t>(gm) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gc = n0 + wn * 32 + ni * 8 + 2 * t;
        const float c0 = acc[ni][mi][2 * half];
        const float c1 = acc[ni][mi][2 * half + 1];
        if (out_vec && gc + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(row + gc) = __floats2bfloat162_rn(c0, c1);
        } else {
          if (gc < N) row[gc] = __float2bfloat16_rn(c0);
          if (gc + 1 < N) row[gc + 1] = __float2bfloat16_rn(c1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// a kernel as launched: its function, tile rows, depth a step, cluster size,
// threads and dynamic shared memory
struct KernelShape {
  const void* fn;
  int bm, bn, bk, cluster, threads;
  size_t smem;
};
KernelShape f32_shape() {
  return {reinterpret_cast<const void*>(pmm_kernel<float>), BM, BN, BK, kCluster,
          kThreads, smem_bytes<float>()};
}
KernelShape bf16_shape() {
  return {reinterpret_cast<const void*>(pmm_kernel_bf16), kTcBM, kTcBN, kTcBK,
          kTcCluster, kTcThreads, kTcSmem};
}

// more than 48 KB of dynamic shared memory must be asked for, once: a call
// of cudaFuncSetAttribute has no place inside a CUDA graph's capture, and
// the first launch (an eager round) makes it before any capture
cudaError_t set_smem(const KernelShape& k, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(k.smem));
  if (err == cudaSuccess) done = true;
  return err;
}
bool f32_smem_set = false;
bool bf16_smem_set = false;

// the launch of an [m, *] x [*, n] call: its grid, with M rounded up to
// whole clusters of k.cluster blocks along M, and the dynamic shared memory
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  Launch(const KernelShape& k, int m, int n, cudaStream_t stream) {
    const int tiles_m = (m + k.bm - 1) / k.bm;
    cfg.gridDim = dim3((n + k.bn - 1) / k.bn,
                       ((tiles_m + k.cluster - 1) / k.cluster) * k.cluster);
    cfg.blockDim = dim3(k.threads);
    cfg.dynamicSmemBytes = k.smem;
    cfg.stream = stream;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = k.cluster;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
};

int launch_f32(const float* x, const float* w, float* out, int m, int k, int n,
               const unsigned int* seed, unsigned int off, const float* eps,
               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  // vector copies and stores need rows of whole 16-byte groups: a base so
  // aligned and a row length that is a multiple of 4
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (k % 4 == 0);
  const int out_vec = (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (n % 4 == 0);
  const KernelShape shape = f32_shape();
  const cudaError_t attr = set_smem(shape, f32_smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Launch l(shape, m, n, static_cast<cudaStream_t>(stream));
  const cudaError_t status = cudaLaunchKernelEx(
      &l.cfg, pmm_kernel<float>, x, w, out, m, k, n, seed, off, eps, x_vec, out_vec);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* w, void* out, int m, int k, int n,
                const unsigned int* seed, unsigned int off, const float* eps,
                void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int x_mode = (xa % 16 == 0 && k % 8 == 0) ? 2 : (xa % 8 == 0 && k % 4 == 0) ? 1 : 0;
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % (2 * kTcDrawCols) == 0) &&
                    (n % kTcDrawCols == 0);
  const int out_vec = (reinterpret_cast<uintptr_t>(out) % 4 == 0) && (n % 2 == 0);
  const KernelShape shape = bf16_shape();
  const cudaError_t attr = set_smem(shape, bf16_smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Launch l(shape, m, n, static_cast<cudaStream_t>(stream));
  const cudaError_t status = cudaLaunchKernelEx(
      &l.cfg, pmm_kernel_bf16, static_cast<const uint16_t*>(x),
      static_cast<const uint16_t*>(w), static_cast<bf16*>(out), m, k, n,
      static_cast<const uint32_t*>(seed), static_cast<uint32_t>(off), eps, x_mode,
      w_vec, out_vec);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

int attributes(const KernelShape& k, bool& smem_done, int m, int n, int* info) {
  cudaError_t status = set_smem(k, smem_done);
  if (status != cudaSuccess) return static_cast<int>(status);
  cudaFuncAttributes fa;
  status = cudaFuncGetAttributes(&fa, k.fn);
  if (status != cudaSuccess) return static_cast<int>(status);
  const Launch l(k, m, n, 0);
  int clusters = 0;
  status = cudaOccupancyMaxActiveClusters(&clusters, k.fn, &l.cfg);
  if (status != cudaSuccess) return static_cast<int>(status);
  int blocks_per_sm = 0;
  status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, k.fn,
                                                         k.threads, k.smem);
  if (status != cudaSuccess) return static_cast<int>(status);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes);
  info[3] = static_cast<int>(k.smem);
  info[4] = k.cluster;
  info[5] = clusters;
  info[6] = blocks_per_sm;
  info[7] = static_cast<int>(l.cfg.gridDim.x * l.cfg.gridDim.y);
  info[8] = k.bm;
  info[9] = k.bn;
  info[10] = k.bk;
  info[11] = k.threads;
  return 0;
}

}  // namespace

// seed points to the leaf's stream seed (one uint32 on the device), read by
// the kernel as it reads eps.
extern "C" int perturbed_matmul_f32(const float* x, const float* w,
                                    float* out, int m, int k, int n,
                                    const unsigned int* seed,
                                    unsigned int off, const float* eps,
                                    void* stream) {
  return launch_f32(x, w, out, m, k, n, seed, off, eps, stream);
}

// The same on bf16 x, w and out (f32 inside; products on the tensor cores).
extern "C" int perturbed_matmul_bf16(const void* x, const void* w, void* out,
                                     int m, int k, int n,
                                     const unsigned int* seed,
                                     unsigned int off, const float* eps,
                                     void* stream) {
  return launch_bf16(x, w, out, m, k, n, seed, off, eps, stream);
}

// The kernel as built and launched for an [m, *] x [*, n] call: info (12
// ints) gets registers per thread, local memory per thread (the f32
// kernel's: the 32-byte stack frame of the precise cosf's reduction for
// large arguments, which z never takes; ptxas -v reports spills apart),
// static and dynamic shared memory per block, the cluster size, the
// clusters resident at once, the blocks resident per SM, the blocks in the
// grid, the output rows and columns a block, the K depth a step and the
// threads a block; of the bf16 kernel (pmm_kernel_bf16) when bf16_x is nonzero.
extern "C" int perturbed_matmul_attributes(int m, int n, int bf16_x, int* info) {
  return bf16_x ? attributes(bf16_shape(), bf16_smem_set, m, n, info)
                : attributes(f32_shape(), f32_smem_set, m, n, info);
}
