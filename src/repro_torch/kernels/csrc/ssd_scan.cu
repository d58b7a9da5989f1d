// Mamba-2 chunked SSD scan for Hopper (sm_90a), ngroups = 1.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas (body
// _ssd_kernel). For each (batch b, head h), sequentially over chunks of Q
// rows (all f32):
//   g        = inclusive cumsum of a_h * dt              [Q]
//   M[i, j]  = (C_i . B_j) * exp(g_i - g_j) for j <= i   [Q, Q]
//   y        = M (x * dt) + exp(g) * (C S)               [Q, P]
//   S       <- exp(g_last) * S + sum_i exp(g_last - g_i) B_i (x*dt)_i^T
// and the final state S is returned.
//
// Shapes: x [B, S, H, P], dt [B, S, H], a [H], b/c [B, S, N] (shared by the
// heads), state0 and the returned state [B, H, P, N] -- the public layout of
// repro.kernels.ops.ssd. The kernel transposes the state into an [N, P] tile
// of shared memory as it reads it and back as it writes it. Main path (full
// mamba2-370m, 5 clients x 8 rows x 64 tokens): B = 40, S = 64, H = 32,
// P = 64, N = 128, Q = 64.
//
// Bound on the H100 at the main-path shape: f32 operations, about 3.7 GFLOP
// (0.055 ms at 67 TFLOP/s) against about 87 MB of x, dt, b, c, y and the
// final state (0.026 ms at 3.35 TB/s). Design: one block of 256 threads per
// (b, h); the loop over chunks inside the block replaces the TPU grid's
// sequential chunk axis, and the [N, P] = 128 x 64 state (32 KB) stays in
// shared memory across chunks. A chunk of 256 rows would need 128 KB for
// each of its B and C tiles, so the chunk is worked in row blocks of T = 64:
// for each query block I, C_I is staged once and every key block J <= I
// streams B_J and (x*dt)_J through shared memory; the state update then
// streams the key blocks again. Shared memory: about 136 KB plus 4 bytes per
// chunk row for g, one block per SM. Each thread owns a 4 x 4 register tile
// of every [64, 64] product and a 8 x 4 tile of the state update; tiles
// move as float4s where the widths allow. The cumsum runs sequentially in
// one thread, as the reference's scan does;
// expf is the precise one. Later work: tensor-core (TF32 / bf16) products
// with a parity tolerance, and more than one block per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;         // rows per query / key block
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int LD = 68;        // padded row stride of every tile (16B rows)
constexpr int kThreads = 256;
constexpr int kFixedFloats = (3 * NMAX + 2 * T) * LD;

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ state0,
           float* __restrict__ y, float* __restrict__ state_out, int S,
           int H, int P, int N, int Q, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                 // state      [NMAX][LD], st[n][p]
  float* ct = st + NMAX * LD;       // C_I^T      [NMAX][LD], ct[n][i]
  float* bt = ct + NMAX * LD;       // B_J^T      [NMAX][LD], bt[n][j]
  float* xd = bt + NMAX * LD;       // (x*dt)_J   [T][LD],    xd[j][p]
  float* mt = xd + T * LD;          // M^T        [T][LD],    mt[j][i]
  float* g = mt + T * LD;           // cumsum     [Q]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const float a_h = a[h];
  const int64_t row0 = static_cast<int64_t>(b) * S;   // first row of batch b

  // Loaders. With vec (N and P multiples of 4, 16-byte aligned bases) each
  // thread moves float4s; lanes walk the rows of a transposed tile, so the
  // shared-memory stores hit distinct banks. Everything past N, P or the
  // rows given is zero.
  // rows x N of src (row stride N, first row r0) -> dst[n][i] (transposed)
  auto load_t = [&](float* dst, const float* src, int64_t r0, int rows,
                    int nrow) {
    if (vec) {
#pragma unroll 4
      for (int e = tid; e < nrow * (NMAX / 4); e += kThreads) {
        const int i = e % nrow;
        const int n = (e / nrow) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < rows && n < N)
          v = *reinterpret_cast<const float4*>(src + (r0 + i) * N + n);
        dst[n * LD + i] = v.x;
        dst[(n + 1) * LD + i] = v.y;
        dst[(n + 2) * LD + i] = v.z;
        dst[(n + 3) * LD + i] = v.w;
      }
    } else {
      for (int e = tid; e < nrow * NMAX; e += kThreads) {
        const int i = e % nrow;
        const int n = e / nrow;
        dst[n * LD + i] = (i < rows && n < N) ? src[(r0 + i) * N + n] : 0.0f;
      }
    }
  };

  // state0 [P, N] -> st[n][p]
  if (state0 != nullptr) {
    load_t(st, state0 + static_cast<int64_t>(bh) * P * N, 0, P, PMAX);
  } else {
    for (int e = tid; e < NMAX * LD; e += kThreads) st[e] = 0.0f;
  }

  // B_J^T and (x*dt)_J for the key rows j0 .. j0 + rows - 1 of the chunk
  auto load_key_block = [&](int64_t q0, int j0, int rows) {
    load_t(bt, bm, row0 + q0 + j0, rows, T);
    if (vec) {
#pragma unroll 4
      for (int e = tid; e < T * (PMAX / 4); e += kThreads) {
        const int j = e / (PMAX / 4);
        const int p = (e % (PMAX / 4)) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j < rows && p < P) {
          const int64_t r = row0 + q0 + j0 + j;
          const float d = dt[r * H + h];
          v = *reinterpret_cast<const float4*>(x + (r * H + h) * P + p);
          v = make_float4(__fmul_rn(v.x, d), __fmul_rn(v.y, d),
                          __fmul_rn(v.z, d), __fmul_rn(v.w, d));
        }
        *reinterpret_cast<float4*>(&xd[j * LD + p]) = v;
      }
    } else {
      for (int e = tid; e < T * PMAX; e += kThreads) {
        const int j = e / PMAX;
        const int p = e % PMAX;
        float v = 0.0f;
        if (j < rows && p < P) {
          const int64_t r = row0 + q0 + j0 + j;
          v = __fmul_rn(x[(r * H + h) * P + p], dt[r * H + h]);
        }
        xd[j * LD + p] = v;
      }
    }
  };

  for (int64_t q0 = 0; q0 < S; q0 += Q) {
    // g = cumsum(a * dt) over the chunk, sequential
    for (int i = tid; i < Q; i += kThreads)
      g[i] = __fmul_rn(a_h, dt[(row0 + q0 + i) * H + h]);
    __syncthreads();
    if (tid == 0) {
      float run = g[0];
      for (int i = 1; i < Q; ++i) {
        run = __fadd_rn(run, g[i]);
        g[i] = run;
      }
    }
    __syncthreads();
    const float g_last = g[Q - 1];
    int resident = -1;              // key block now in bt / xd

    for (int i0 = 0; i0 < Q; i0 += T) {
      const int rows_i = min(T, Q - i0);
      load_t(ct, cm, row0 + q0 + i0, rows_i, T);
      __syncthreads();

      // inter-chunk term: cs = C_I S_prev, rows ty*4+r, columns tx*4+c
      float cs[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&ct[n * LD + ty * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(&st[n * LD + tx * 4]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) cs[r][c] = fmaf(ca[r], sa[c], cs[r][c]);
      }

      float acc[4][4] = {};
      for (int j0 = 0; j0 <= i0; j0 += T) {
        const int rows_j = min(T, Q - j0);
        if (resident != j0) {
          __syncthreads();          // earlier readers of bt / xd are done
          load_key_block(q0, j0, rows_j);
          resident = j0;
        }
        __syncthreads();
        // M^T for this (I, J) pair: query rows ty*4+r, key rows tx*4+c
        float cb[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(&ct[n * LD + ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&bt[n * LD + tx * 4]);
          const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
          const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) cb[r][c] = fmaf(ca[r], ba[c], cb[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx * 4 + c;
            float v = 0.0f;
            if (i < rows_i && j < rows_j && j0 + j <= i0 + i)
              v = __fmul_rn(cb[r][c],
                            expf(__fsub_rn(g[i0 + i], g[j0 + j])));
            mt[j * LD + i] = v;
          }
        }
        __syncthreads();
        // intra-chunk term: acc += M (x*dt)_J, rows ty*4+r, columns tx*4+c
#pragma unroll 4
        for (int j = 0; j < rows_j; ++j) {
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
        const float eg = expf(g[i0 + i]);
        const int64_t rr = row0 + q0 + i0 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (p < P)
            y[(rr * H + h) * P + p] =
                __fadd_rn(acc[r][c], __fmul_rn(eg, cs[r][c]));
        }
      }
      __syncthreads();              // ct is reloaded for the next I
    }

    // state update: rows n = ty*8+r, columns p = tx*4+c; key blocks from
    // the last (still resident) to the first
    float sacc[8][4] = {};
    const int last = ((Q - 1) / T) * T;
    for (int j0 = last; j0 >= 0; j0 -= T) {
      const int rows_j = min(T, Q - j0);
      if (resident != j0) {
        __syncthreads();
        load_key_block(q0, j0, rows_j);
        resident = j0;
      }
      __syncthreads();
      for (int j = 0; j < rows_j; ++j) {
        const float wj = expf(__fsub_rn(g_last, g[j0 + j]));
        const float4 xv = *reinterpret_cast<const float4*>(&xd[j * LD + tx * 4]);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float bw = __fmul_rn(wj, bt[(ty * 8 + r) * LD + j]);
#pragma unroll
          for (int c = 0; c < 4; ++c) sacc[r][c] = fmaf(bw, xa[c], sacc[r][c]);
        }
      }
    }
    __syncthreads();                // every reader of the old state is done
    const float e_last = expf(g_last);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* sp = &st[(ty * 8 + r) * LD + tx * 4 + c];
        *sp = __fadd_rn(__fmul_rn(e_last, *sp), sacc[r][c]);
      }
    }
    __syncthreads();
  }

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

}  // namespace

extern "C" int ssd_scan_smem_bytes(int chunk) {
  return static_cast<int>((kFixedFloats + chunk) * sizeof(float));
}

extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* b, const float* c,
                            const float* state0, float* y, float* state_out,
                            int batch, int seq, int heads, int head_dim,
                            int d_state, int chunk, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (head_dim > PMAX || d_state > NMAX || chunk <= 0 || seq % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // float4 loads and stores need rows of a multiple of 4 floats on
  // 16-byte aligned bases
  const float* bases[] = {x, b, c, state0, y, state_out};
  int vec = (head_dim % 4 == 0) && (d_state % 4 == 0);
  for (const float* ptr : bases)
    vec = vec && (reinterpret_cast<uintptr_t>(ptr) % 16 == 0);
  const int smem = ssd_scan_smem_bytes(chunk);
  static int allowed = 0;           // opt-in above 48 KB, raised as needed
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  ssd_kernel<<<batch * heads, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, b, c, state0, y, state_out, seq, heads, head_dim, d_state,
      chunk, vec);
  return static_cast<int>(cudaGetLastError());
}
