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
// bf16 x and w (perturbed_matmul_bf16), as the TPU kernel computes them: w
// is widened to f32 where it is loaded and w + eps * z formed in f32 (not
// rounded to bf16), x tiles are copied as bf16 (8-byte cp.async, half the
// shared memory) and widened where the product reads them, the sums stay
// f32, and each output is rounded once to bf16, to nearest even. The
// identity probe (x = I) returns what seeded_axpy_bf16 writes, bitwise.
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
// bytes for f32 x, 45,824 for bf16
template <typename Elem>
constexpr size_t smem_bytes() {
  return sizeof(Elem) * kXStages * BM * LDX + sizeof(float) * kWStages * BK * LDW;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
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

// more than 48 KB of dynamic shared memory must be asked for, once: a call
// of cudaFuncSetAttribute has no place inside a CUDA graph's capture, and
// the first launch (an eager round) makes it before any capture
template <typename Elem>
bool smem_set = false;

template <typename Elem>
cudaError_t set_smem() {
  if (smem_set<Elem>) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      pmm_kernel<Elem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<Elem>()));
  if (err == cudaSuccess) smem_set<Elem> = true;
  return err;
}

// the launch of an [m, *] x [*, n] call: its grid, with M rounded up to
// whole clusters of kCluster blocks along M, and the dynamic shared memory
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  Launch(int m, int n, size_t smem, cudaStream_t stream) {
    const int tiles_m = (m + BM - 1) / BM;
    cfg.gridDim = dim3((n + BN - 1) / BN,
                       ((tiles_m + kCluster - 1) / kCluster) * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = kCluster;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
};

template <typename Elem>
int launch_pmm(const Elem* x, const Elem* w, Elem* out, int m, int k, int n,
               const unsigned int* seed, unsigned int off, const float* eps,
               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  // vector copies and stores need rows aligned to 4 elements (16 bytes in
  // f32, 8 in bf16): a base so aligned and a row length that is a
  // multiple of 4
  constexpr uintptr_t kAlign = 4 * sizeof(Elem);
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % kAlign == 0) && (k % 4 == 0);
  const int out_vec =
      (reinterpret_cast<uintptr_t>(out) % kAlign == 0) && (n % 4 == 0);
  const cudaError_t attr = set_smem<Elem>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Launch l(m, n, smem_bytes<Elem>(), static_cast<cudaStream_t>(stream));
  const cudaError_t status =
      cudaLaunchKernelEx(&l.cfg, pmm_kernel<Elem>, x, w, out, m, k, n, seed,
                         off, eps, x_vec, out_vec);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem>
int attributes(int m, int n, int* info) {
  cudaError_t status = set_smem<Elem>();
  if (status != cudaSuccess) return static_cast<int>(status);
  cudaFuncAttributes fa;
  status = cudaFuncGetAttributes(&fa, pmm_kernel<Elem>);
  if (status != cudaSuccess) return static_cast<int>(status);
  const Launch l(m, n, smem_bytes<Elem>(), 0);
  int clusters = 0;
  status = cudaOccupancyMaxActiveClusters(&clusters, pmm_kernel<Elem>, &l.cfg);
  if (status != cudaSuccess) return static_cast<int>(status);
  int blocks_per_sm = 0;
  status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks_per_sm, pmm_kernel<Elem>, kThreads, smem_bytes<Elem>());
  if (status != cudaSuccess) return static_cast<int>(status);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes);
  info[3] = static_cast<int>(smem_bytes<Elem>());
  info[4] = kCluster;
  info[5] = clusters;
  info[6] = blocks_per_sm;
  info[7] = static_cast<int>(l.cfg.gridDim.x * l.cfg.gridDim.y);
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
  return launch_pmm(x, w, out, m, k, n, seed, off, eps, stream);
}

// The same on bf16 x, w and out (f32 inside).
extern "C" int perturbed_matmul_bf16(const void* x, const void* w, void* out,
                                     int m, int k, int n,
                                     const unsigned int* seed,
                                     unsigned int off, const float* eps,
                                     void* stream) {
  return launch_pmm(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                    static_cast<bf16*>(out), m, k, n, seed, off, eps, stream);
}

// The kernel as built and launched for an [m, *] x [*, n] call: info gets
// registers per thread, local memory per thread (the 32-byte stack frame of
// the precise cosf's reduction for large arguments, which z never takes;
// ptxas -v reports spills apart), static and dynamic shared memory per
// block, the cluster size, the clusters resident at once, the blocks
// resident per SM and the blocks in the grid; of the bf16 instance when
// bf16_x is nonzero.
extern "C" int perturbed_matmul_attributes(int m, int n, int bf16_x, int* info) {
  return bf16_x ? attributes<bf16>(m, n, info) : attributes<float>(m, n, info);
}
