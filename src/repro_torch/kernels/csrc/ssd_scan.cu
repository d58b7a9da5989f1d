// Mamba-2 chunked SSD scan for Hopper (sm_90a), ngroups = 1.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas (body
// _ssd_kernel). For each (batch b, head h), sequentially over chunks of Q
// rows (all f32):
//   g        = inclusive cumsum of a_h * dt              [Q]
//   M[i, j]  = (C_i . B_j) * exp(g_i - g_j) for j <= i   [Q, Q]
//   y        = M (x * dt) + exp(g) * (C S)               [Q, P]
//   S       <- exp(g_last) * S + sum_i exp(g_last - g_i) B_i (x*dt)_i^T
// and the final state S when the caller asks for it.
//
// Shapes: x [B, S, H, P], dt [B, S, H], a [H], b/c [B, S, N] (shared by the
// heads), state0 and the returned state [B, H, P, N] -- the public layout of
// repro.kernels.ops.ssd. Main path (full mamba2-370m in training, 5
// clients x 8 rows x 64 tokens): B = 40, S = 64, H = 32, P = 64, N = 128,
// Q = 64: one chunk, no state in, none out.
//
// Bound on the H100 at the main-path shape, counting what the call needs:
// y only, 0.36 GFLOP (C.B^T once per batch row, M (x*dt) per head, both
// over their causal half; 5.4 us at 67 TFLOP/s) against 44.9 MB of x, dt,
// b, c and y (13.4 us at 3.35 TB/s); with the final state, 1.70 GFLOP
// (25.4 us) against 86.8 MB (25.9 us). Bytes bound both.
//
// Design, two launches a call:
//   ssd_cb_kernel computes C_i . B_j once per (b, chunk) for all heads
//     into a scratch cbt[row j][column i] of B*S rows of QP = Q rounded up
//     to 4 floats (655 KB at the main shape, which stays in L2); a block
//     takes 16 key rows of a chunk and every query block at or after them.
//   ssd_kernel<kState> is one block of 256 threads per (b, h), launched
//     as the first kernel's programmatic dependent: its blocks start while
//     that grid runs, copy x and read dt, and wait (griddepcontrol.wait)
//     only before they read cbt. A loop over chunks inside the block
//     replaces the TPU grid's sequential chunk axis. For each query block
//     I of T = 64 rows and key block J <= I it copies x_J and the cbt tile
//     into shared memory by cp.async, scales x_J by dt and turns the tile
//     into M^T = cbt * exp(g_i - g_j) [i >= j] in place, and adds
//     M (x*dt)_J into a 4 x 4 register tile per thread; on the diagonal
//     tile each warp stops at its own last row. kState = false (one
//     chunk, no state in or out: the training call) holds only those two
//     tiles, 35 KB, so four blocks share an SM. kState = true adds the
//     [N, P] state and one [N, T] tile of C_I^T or B_J^T (104 KB, two
//     blocks an SM); it skips C S when the state is known to be zero
//     (chunk 0 without state0) and the last chunk's state update when no
//     state is returned.
// exp(g_i - g_j) is never split into exp(g_i) exp(-g_j): g falls far
// below zero along a chunk and exp(-g_j) would overflow. The cumsum runs
// sequentially in one thread, as the reference's scan does; expf is the
// precise one. Later work: tensor-core (TF32 / bf16) products with a
// parity tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows per query / key block
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int LD = 68;         // padded row stride of every tile (16B rows)
constexpr int kThreads = 256;
constexpr int kStrip = 16;     // key rows per block of ssd_cb_kernel
constexpr int LDB = NMAX + 4;  // row stride of ssd_cb_kernel's B strip

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// rows x N of src (row stride N, first row r0) -> dst[n][i] (transposed),
// i < 64; zero past `rows`. Rows n >= N are left as they are: every
// product runs over n < N. With vec each thread starts all its float4
// loads before its first store, and lanes walk the rows of the tile, so
// the shared-memory stores hit distinct banks.
__device__ __forceinline__ void load_t(float* dst,
                                       const float* __restrict__ src,
                                       int64_t r0, int rows, int N, int vec) {
  constexpr int kCols = 64;
  if (vec) {
    constexpr int kPer = kCols * (NMAX / 4) / kThreads;
    const int total = kCols * (N / 4);
    float4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int i = e % kCols;
      v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e < total && i < rows)
        v[k] = *reinterpret_cast<const float4*>(src + (r0 + i) * N
                                                + (e / kCols) * 4);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int i = e % kCols;
      const int n = (e / kCols) * 4;
      if (e < total) {
        dst[n * LD + i] = v[k].x;
        dst[(n + 1) * LD + i] = v[k].y;
        dst[(n + 2) * LD + i] = v[k].z;
        dst[(n + 3) * LD + i] = v[k].w;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kCols * N; e += kThreads) {
      const int i = e % kCols;
      const int n = e / kCols;
      dst[n * LD + i] = i < rows ? src[(r0 + i) * N + n] : 0.0f;
    }
  }
}

// cbt[r0 + j][i] = C_i . B_j for the key rows j of one 16-row strip of a
// chunk (r0 its first row) and every query column i of the blocks at or
// after the strip's; thread (jr, ic) sums row jr against columns
// ic*4 .. ic*4+3 of a block, n in order.
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cbt, int S, int N, int Q, int QP, int vec) {
  __shared__ float bs[kStrip * LDB];           // B strip, bs[j][n]
  __shared__ __align__(16) float ct[NMAX * LD];  // C_I^T,  ct[n][i]
  // ssd_kernel may start its blocks now: they wait for this grid's end
  // (griddepcontrol.wait) before they read cbt
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int jr = tid / 16;
  const int ic = tid % 16;
  const int nc = S / Q;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / nc) * S
                     + static_cast<int64_t>(blockIdx.x % nc) * Q;
  const int js = blockIdx.y * kStrip;
  const int rows_s = min(kStrip, Q - js);
  // the B strip by cp.async, in flight with the first C tile's loads
  if (vec) {
    for (int e = tid; e < kStrip * (N / 4); e += kThreads) {
      const int j = e / (N / 4);
      const int n = (e % (N / 4)) * 4;
      const bool ok = j < rows_s;
      cp_async16(&bs[j * LDB + n], ok ? bm + (r0 + js + j) * N + n : bm,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kStrip * N; e += kThreads) {
      const int j = e / N;
      const int n = e % N;
      bs[j * LDB + n] = j < rows_s ? bm[(r0 + js + j) * N + n] : 0.0f;
    }
  }
  const int first = (js / T) * T;
  for (int i0 = first; i0 < Q; i0 += T) {
    const int rows_i = min(T, Q - i0);
    if (i0 != first) __syncthreads();  // earlier readers of ct are done
    load_t(ct, cm, r0 + i0, rows_i, N, vec);
    cp_async_wait_all();
    __syncthreads();
    float o[4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float bv = bs[jr * LDB + n];
      const float4 cv = *reinterpret_cast<const float4*>(&ct[n * LD + ic * 4]);
      o[0] = fmaf(cv.x, bv, o[0]);
      o[1] = fmaf(cv.y, bv, o[1]);
      o[2] = fmaf(cv.z, bv, o[2]);
      o[3] = fmaf(cv.w, bv, o[3]);
    }
    if (jr < rows_s && ic * 4 < rows_i)
      *reinterpret_cast<float4*>(cbt + (r0 + js + jr) * QP + i0 + ic * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
  }
}

template <bool kState>
__global__ void __launch_bounds__(kThreads, kState ? 2 : 4)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ cbt,
           const float* __restrict__ state0, float* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int P, int N, int Q,
           int QP, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStateFloats = kState ? 2 * NMAX * LD : 0;
  float* xd = smem;                 // (x*dt)_J   [T][LD],    xd[j][p]
  float* mt = xd + T * LD;          // M^T        [T][LD],    mt[j][i]
  float* st = mt + T * LD;          // state      [NMAX][LD], st[n][p]
  float* nt = st + NMAX * LD;       // C_I^T or B_J^T [NMAX][LD]
  float* dts = mt + T * LD + kStateFloats;  // dt of the chunk [Q]
  float* g = dts + QP;              // cumsum     [Q]
  float* wl = g + QP;               // exp(g_last - g)  [Q]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const float a_h = a[h];
  const int nc = S / Q;

  // (x*dt)_J for the key rows j0 .. j0 + rows - 1 of the chunk starting
  // at row q0, zero past P and past `rows`, in two steps: start_x starts
  // the copy of x (with vec: cp.async of the thread's own float4s); once
  // the thread has waited for its copies, finish_x scales each row by its
  // dt in place, so xd holds x*dt rounded as the reference rounds it
  constexpr int kXGroups = T * (PMAX / 4) / kThreads;
  auto start_x = [&](int64_t q0, int j0, int rows) {
    if (!vec) return;
#pragma unroll
    for (int k = 0; k < kXGroups; ++k) {
      const int e = tid + k * kThreads;
      const int j = e / (PMAX / 4);
      const int p = (e % (PMAX / 4)) * 4;
      const bool ok = j < rows && p < P;
      cp_async16(&xd[j * LD + p],
                 ok ? x + ((q0 + j0 + j) * H + h) * P + p : x, ok ? 16 : 0);
    }
  };
  auto finish_x = [&](int64_t q0, int j0, int rows) {
    if (vec) {
#pragma unroll 1
      for (int k = 0; k < kXGroups; ++k) {
        const int e = tid + k * kThreads;
        const int j = e / (PMAX / 4);
        const int p = (e % (PMAX / 4)) * 4;
        if (j < rows && p < P) {
          const float d = dts[j0 + j];
          float4* v = reinterpret_cast<float4*>(&xd[j * LD + p]);
          *v = make_float4(__fmul_rn(v->x, d), __fmul_rn(v->y, d),
                           __fmul_rn(v->z, d), __fmul_rn(v->w, d));
        }
      }
    } else {
      for (int e = tid; e < T * PMAX; e += kThreads) {
        const int j = e / PMAX;
        const int p = e % PMAX;
        float v = 0.0f;
        if (j < rows && p < P)
          v = __fmul_rn(x[((q0 + j0 + j) * H + h) * P + p], dts[j0 + j]);
        xd[j * LD + p] = v;
      }
    }
  };
  // the C.B^T tile of (I, J) into mt, float4 groups (key row j, query
  // columns i4 .. i4+3) with an unmasked entry only; build_m turns each
  // of the thread's own groups into M^T in place, zero above the diagonal
  constexpr int kMGroups = T * (T / 4) / kThreads;
  auto start_cb = [&](int64_t q0, int i0, int j0, int rows_i, int rows_j) {
#pragma unroll
    for (int k = 0; k < kMGroups; ++k) {
      const int e = tid + k * kThreads;
      const int j = e / (T / 4);
      const int i4 = (e % (T / 4)) * 4;
      if (j < rows_j && i4 < rows_i && j0 + j <= i0 + i4 + 3)
        cp_async16(&mt[j * LD + i4], cbt + (q0 + j0 + j) * QP + i0 + i4, 16);
    }
  };
  auto build_m = [&](int i0, int j0, int rows_i, int rows_j) {
#pragma unroll 1
    for (int k = 0; k < kMGroups; ++k) {
      const int e = tid + k * kThreads;
      const int j = e / (T / 4);
      const int i4 = (e % (T / 4)) * 4;
      float4* mp = reinterpret_cast<float4*>(&mt[j * LD + i4]);
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < rows_j && i4 < rows_i && j0 + j <= i0 + i4 + 3) {
        const float4 cb = *mp;
        const float cba[4] = {cb.x, cb.y, cb.z, cb.w};
        const float gj = g[j0 + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i4 + c;
          if (i < rows_i && j0 + j <= i0 + i)
            v[c] = __fmul_rn(cba[c], expf(__fsub_rn(g[i0 + i], gj)));
        }
      }
      *mp = make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  if constexpr (kState) {
    // state0 [P, N] -> st[n][p]
    if (state0 != nullptr) {
      load_t(st, state0 + static_cast<int64_t>(bh) * P * N, 0, P, N, vec);
    } else {
      for (int e = tid; e < NMAX * LD; e += kThreads) st[e] = 0.0f;
    }
  }

  for (int ci = 0; ci < nc; ++ci) {
    const int64_t q0 = static_cast<int64_t>(b) * S
                       + static_cast<int64_t>(ci) * Q;  // first row
    __syncthreads();                // every reader of the last chunk is done
    // the first step's copies fly while dt is read and summed
    start_x(q0, 0, min(T, Q));
    for (int i = tid; i < Q; i += kThreads) {
      const float d = dt[(q0 + i) * H + h];
      dts[i] = d;
      g[i] = __fmul_rn(a_h, d);
    }
    // cbt is ssd_cb_kernel's output (launched as its programmatic
    // dependent: everything above overlaps that kernel's end)
    if (ci == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    start_cb(q0, 0, 0, min(T, Q), min(T, Q));
    __syncthreads();
    // g = cumsum(a * dt), sequential, four values a load; read only
    // after the next barrier
    if (tid == 0) {
      float run = -0.0f;            // -0 + v is v: g[0] stays a * dt[0]
      int i = 0;
      for (; i + 4 <= Q; i += 4) {
        float4 v = *reinterpret_cast<float4*>(&g[i]);
        v.x = run = __fadd_rn(run, v.x);
        v.y = run = __fadd_rn(run, v.y);
        v.z = run = __fadd_rn(run, v.z);
        v.w = run = __fadd_rn(run, v.w);
        *reinterpret_cast<float4*>(&g[i]) = v;
      }
      for (; i < Q; ++i) g[i] = run = __fadd_rn(run, g[i]);
    }
    // the carried state is zero on chunk 0 without state0: skip C S there
    const bool carry_in = kState && (state0 != nullptr || ci > 0);
    int resident = 0;               // key block in xd (or on its way)
    bool scale_x = true;            // xd still needs finish_x
    bool started = true;            // this step's copies are on their way

    for (int i0 = 0; i0 < Q; i0 += T) {
      const int rows_i = min(T, Q - i0);
      float cs[4][4] = {};
      if constexpr (kState) {
        if (carry_in) {
          // inter-chunk term: cs = C_I S_prev, rows ty*4+r, columns tx*4+c
          __syncthreads();          // earlier readers of nt are done
          load_t(nt, cm, q0 + i0, rows_i, N, vec);
          __syncthreads();
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float4 cv =
                *reinterpret_cast<const float4*>(&nt[n * LD + ty * 4]);
            const float4 sv =
                *reinterpret_cast<const float4*>(&st[n * LD + tx * 4]);
            const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
            const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                cs[r][c] = fmaf(ca[r], sa[c], cs[r][c]);
          }
        }
      }

      float acc[4][4] = {};
      for (int j0 = 0; j0 <= i0; j0 += T) {
        const int rows_j = min(T, Q - j0);
        if (!started) {
          __syncthreads();          // earlier readers of xd and mt are done
          if (resident != j0) {
            start_x(q0, j0, rows_j);
            resident = j0;
            scale_x = true;
          }
          start_cb(q0, i0, j0, rows_i, rows_j);
        }
        started = false;
        cp_async_wait_all();
        if (scale_x) {
          finish_x(q0, j0, rows_j);
          scale_x = false;
        }
        __syncthreads();            // g ready
        build_m(i0, j0, rows_i, rows_j);
        __syncthreads();
        // intra-chunk term: acc += M (x*dt)_J, rows ty*4+r, columns
        // tx*4+c; on the diagonal M is zero past the warp's last row.
        // Not unrolled: within 64 registers an unrolled loop spills more
        // and ran no faster (chip_ssd_variants.py, product_unroll_4)
        const int j_end = j0 == i0 ? min(rows_j, (ty | 1) * 4 + 4) : rows_j;
#pragma unroll 1
        for (int j = 0; j < j_end; ++j) {
          const float4 mv = *reinterpret_cast<const float4*>(&mt[j * LD + ty * 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&xd[j * LD + tx * 4]);
          const float ma[4] = {mv.x, mv.y, mv.z, mv.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ma[r], xa[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (i >= rows_i) continue;
        if (carry_in) {
          const float eg = expf(g[i0 + i]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(eg, cs[r][c]));
        }
        float* yr = y + ((q0 + i0 + i) * H + h) * P;
        if (vec) {
          if (tx * 4 < P)
            *reinterpret_cast<float4*>(yr + tx * 4) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (tx * 4 + c < P) yr[tx * 4 + c] = acc[r][c];
        }
      }
    }

    if constexpr (kState) {
      if (state_out == nullptr && ci + 1 == nc) break;  // no state asked for
      // state update: rows n = ty*8+r, columns p = tx*4+c; key blocks from
      // the last (its x*dt still resident) to the first
      const float g_last = g[Q - 1];
      for (int i = tid; i < Q; i += kThreads)
        wl[i] = expf(__fsub_rn(g_last, g[i]));
      float sacc[8][4] = {};
      for (int j0 = ((Q - 1) / T) * T; j0 >= 0; j0 -= T) {
        const int rows_j = min(T, Q - j0);
        __syncthreads();            // earlier readers of nt and xd are done
        const bool fresh = resident != j0;
        if (fresh) {
          start_x(q0, j0, rows_j);
          resident = j0;
        }
        load_t(nt, bm, q0 + j0, rows_j, N, vec);
        if (fresh) {
          cp_async_wait_all();
          finish_x(q0, j0, rows_j);
        }
        __syncthreads();
        for (int j = 0; j < rows_j; ++j) {
          const float wj = wl[j0 + j];
          const float4 xv = *reinterpret_cast<const float4*>(&xd[j * LD + tx * 4]);
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float bw = __fmul_rn(wj, nt[(ty * 8 + r) * LD + j]);
#pragma unroll
            for (int c = 0; c < 4; ++c) sacc[r][c] = fmaf(bw, xa[c], sacc[r][c]);
          }
        }
      }
      __syncthreads();              // every reader of the old state is done
      const float e_last = expf(g_last);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* sp = &st[(ty * 8 + r) * LD + tx * 4 + c];
          *sp = __fadd_rn(__fmul_rn(e_last, *sp), sacc[r][c]);
        }
      }
    }
  }

  if constexpr (kState) {
    if (state_out == nullptr) return;
    __syncthreads();
    // st[n][p] -> state_out [P, N]
    float* so = state_out + static_cast<int64_t>(bh) * P * N;
    if (vec) {
#pragma unroll 4
      for (int e = tid; e < PMAX * (NMAX / 4); e += kThreads) {
        const int p = e % PMAX;
        const int n = (e / PMAX) * 4;
        if (p < P && n < N)
          *reinterpret_cast<float4*>(so + p * N + n) =
              make_float4(st[n * LD + p], st[(n + 1) * LD + p],
                          st[(n + 2) * LD + p], st[(n + 3) * LD + p]);
      }
    } else {
      for (int e = tid; e < PMAX * NMAX; e += kThreads) {
        const int p = e % PMAX;
        const int n = e / PMAX;
        if (p < P && n < N) so[p * N + n] = st[n * LD + p];
      }
    }
  }
}

int smem_bytes(bool state, int chunk) {
  const int tiles = 2 * T * LD + (state ? 2 * NMAX * LD : 0);
  return static_cast<int>((tiles + 3 * ((chunk + 3) / 4 * 4)) * sizeof(float));
}

// Opt in above 48 KB of dynamic shared memory for `kernel`, as needed.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

int allowed_y = 0;
int allowed_state = 0;

}  // namespace

extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* b, const float* c,
                            const float* state0, float* y, float* state_out,
                            float* cb, int batch, int seq, int heads,
                            int head_dim, int d_state, int chunk,
                            void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (head_dim > PMAX || d_state > NMAX || chunk <= 0 || seq % chunk != 0
      || reinterpret_cast<uintptr_t>(cb) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // float4 loads and stores need rows of a multiple of 4 floats on
  // 16-byte aligned bases
  const float* bases[] = {x, b, c, state0, y, state_out};
  int vec = (head_dim % 4 == 0) && (d_state % 4 == 0);
  for (const float* ptr : bases)
    vec = vec && (reinterpret_cast<uintptr_t>(ptr) % 16 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = seq / chunk;
  const int qp = (chunk + 3) / 4 * 4;   // the wrapper sizes cb as batch*seq*qp
  ssd_cb_kernel<<<dim3(batch * n_chunks, (chunk + kStrip - 1) / kStrip),
                  kThreads, 0, s>>>(b, c, cb, seq, d_state, chunk, qp, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool state = state0 != nullptr || state_out != nullptr
                     || n_chunks > 1;
  // the head pass is the C.B^T pass's programmatic dependent: its blocks
  // may start before that grid ends, and wait for it before reading cb
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(state, chunk);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  if (state) {
    err = allow_smem(ssd_kernel<true>, cfg.dynamicSmemBytes, &allowed_state);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, ssd_kernel<true>, x, dt, a, b, c, cb,
                               state0, y, state_out, seq, heads, head_dim,
                               d_state, chunk, qp, vec);
  } else {
    err = allow_smem(ssd_kernel<false>, cfg.dynamicSmemBytes, &allowed_y);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, ssd_kernel<false>, x, dt, a, b, c, cb,
                               state0, y, state_out, seq, heads, head_dim,
                               d_state, chunk, qp, vec);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Per kernel (ssd_cb_kernel, ssd_kernel<false>, ssd_kernel<true>, in that
// order) as built for a call with this chunk on the current device: five
// ints each into info[15] -- registers and local memory bytes per thread,
// static and dynamic shared memory bytes per block, resident blocks per SM.
extern "C" int ssd_scan_attributes(int chunk, int* info) {
  cudaError_t err = allow_smem(ssd_kernel<false>, smem_bytes(false, chunk),
                               &allowed_y);
  if (err == cudaSuccess)
    err = allow_smem(ssd_kernel<true>, smem_bytes(true, chunk),
                     &allowed_state);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernels[] = {reinterpret_cast<const void*>(ssd_cb_kernel),
                           reinterpret_cast<const void*>(ssd_kernel<false>),
                           reinterpret_cast<const void*>(ssd_kernel<true>)};
  const int dynamic[] = {0, smem_bytes(false, chunk), smem_bytes(true, chunk)};
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernels[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernels[k], kThreads, dynamic[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int* row = info + 5 * k;
    row[0] = fa.numRegs;
    row[1] = static_cast<int>(fa.localSizeBytes);
    row[2] = static_cast<int>(fa.sharedSizeBytes);
    row[3] = dynamic[k];
    row[4] = blocks;
  }
  return 0;
}
