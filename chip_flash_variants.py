#!/usr/bin/env python3
"""Where flash_attention's time goes on one GPU, measured by taking pieces
away and by changing one design choice at a time.

    python3 chip_flash_variants.py [--head-dim 256|192|128|96]
                                   [--baseline FILE.cu] [variant ...]
    python3 chip_flash_variants.py --dtype bf16 [--head-dim 64|128]
                                   [--main LABEL] [--baseline FILE.cu]
                                   [variant ...]

Each variant is src/repro_torch/kernels/csrc/flash_attention.cu with one or
more text substitutions (VARIANTS below for the head_dim-256 kernel,
TC_VARIANTS for the tensor-core kernel at 96, 128 and 192; an anchor
that no longer matches the source raises), built with nvcc into
build/flash_variants/ and called through the port's own wrapper. At
head_dim 256 (the default) the shape is recurrentgemma-2b's attention (q
[40,10,64,256] on k/v [40,1,64,256], causal, window 2048); `--head-dim
192` takes deepseek-v2's MLA training shape (q/k/v [40,128,64,192],
causal), `--head-dim 96` minicpm3-4b's ([40,40,64,96]) and `--head-dim
128` moonshot's GQA training shape ([40,16,64,128]), each also timed at
TC_TIMED's shapes (the serve prefill; at 128 yi-6b's and a 2048-token
prompt), with TC_VARIANTS: key tiles of 16 or 64, ring slots, blocks an
SM or a register cap, P through shared memory or by shuffles instead of
in place, the split's rounding, where the scores are summed, S's 8-key
blocks scored apart or a whole tile at once, and `skip_lo_terms`
(one TF32 pass, timed only: never the kernel, which needs three); each
checked variant also prints its largest share of the flash gate and, at
inputs x8, its distance from the f64 value beside attention_plain's.
`--dtype bf16` takes the bf16 kernel (`flash_fwd_bf16_kernel`) with
BF16_VARIANTS: at 64 (the default) OPT-125M's training shape
([40,12,64,64], causal), also timed at whisper-medium's encoder
([40,16,1500,64], non-causal) and cross-attention (q [40,16,64,64] on
1500 keys); at 128 yi-6b's prefill (q [4,32,32,128] on [4,4,32,128]),
also timed at a 2048-token prompt (`--main` makes one of these timed
shapes the main one: checked, traced and timed first); design variants
(rows an item, key tile, K/V a row a copy or in blocks, ring slots,
blocks an SM, unrolling, the producer's order, the output divided a value
at a time) held within one bf16 ulp of `attention_plain` in f32 (chip_smoke's
`within_bf16_ulp`) and to two calls bitwise, `skip_lo_pass` (P in one
bf16 piece, as SDPA in bf16: another function) timed with its reading in
those ulps printed, and a `skip_*` variant for each phase. Substitutions
of the bf16 variants apply to the bf16 kernel's part of the source
only, those of the f32 variants to the rest. `--baseline`
adds one more variant, "baseline": another flash_attention.cu built as it
is (an older version of the source, to time against in the same call;
in bf16 its `flash_attention_bf16`).
Three kinds:
  - design variants change one choice (threads, rows an item, persistence,
    FMA order, unrolling, Q copies) and are held against `attention_plain`
    to rtol = atol = 1e-5 first, at that shape and at two that exercise
    the head chunks and the online rescale;
  - `trace` is the kernel with clock stamps at its barriers: it prints
    each block's end on the global clock and, for four blocks, the cycles
    between consecutive stamps (A, B, C, after P V, after an item's
    stores);
  - `skip_*` variants leave a phase out (or feed one operand of a product
    from registers instead of shared memory), compute a wrong result by
    construction and are only timed: what they save is that phase's share
    of the call.
Variants join with "+" (`bk_32+min_blocks_4`: the substitutions of both).
Every variant runs twice, in the order given and then reversed, on the
same inputs. Printed per run: the device time of one call (its kernel's
self time under torch.profiler, mean of 20 calls); per variant, ptxas's
registers and spill bytes of the head-dim's kernel and, from the built
library, its registers, shared memory and blocks an SM. Needs one CUDA
device and nvcc; exits non-zero without either.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"
MAIN = ((40, 10, 64, 256), (40, 1, 64, 256), True, 2048)
CHECKS = (MAIN,
          ((2, 6, 40, 256), (2, 2, 40, 256), True, None),     # group 3
          ((2, 10, 64, 256), (2, 1, 300, 256), True, None))   # many tiles
# the tensor-core kernel's shapes: the training shape (MLA's at 96 and
# 192, moonshot's GQA at 128), group 8 with a window and Sq < Skv, and 300
# keys (the online rescale over ten tiles)
TC_MAIN = {192: ((40, 128, 64, 192), (40, 128, 64, 192), True, None),
           128: ((40, 16, 64, 128), (40, 16, 64, 128), True, None),
           96: ((40, 40, 64, 96), (40, 40, 64, 96), True, None)}
# and the shapes timed beside it, causal: the serve prefill (batch 4,
# prompt 32; yi-6b's at 128) and at 128 a 2048-token prompt
TC_TIMED = {192: {"prefill": ((4, 128, 32, 192), (4, 128, 32, 192))},
            128: {"prefill": ((4, 32, 32, 128), (4, 4, 32, 128)),
                  "prompt 2048": ((1, 32, 2048, 128), (1, 4, 2048, 128))},
            96: {"prefill": ((4, 40, 32, 96), (4, 40, 32, 96))}}


# the bf16 kernel's shapes: the training or prefill shape it is tuned at,
# and the shapes timed beside it
BF16_MAIN = {64: ((40, 12, 64, 64), (40, 12, 64, 64), True, None),
             128: ((4, 32, 32, 128), (4, 4, 32, 128), True, None)}
BF16_TIMED = {64: {"whisper encoder": ((40, 16, 1500, 64),
                                       (40, 16, 1500, 64), False),
                   "whisper cross": ((40, 16, 64, 64), (40, 16, 1500, 64),
                                     False)},
              128: {"prompt 2048": ((1, 32, 2048, 128), (1, 4, 2048, 128),
                                    True)}}
# the bf16 kernel's part of the source (its design note to the end of the
# anonymous namespace)
BF16_BEGIN = "// bf16 at head_dim 16, 32, 64 and 128 (flash_fwd_bf16_kernel"
BF16_END = "}  // namespace"


def extra_checks(d: int) -> tuple:
    return (((2, 16, 45, d), (2, 2, 130, d), True, 40),
            ((2, 4, 70, d), (2, 2, 300, d), True, None))


def tc_checks(d: int) -> tuple:
    return (TC_MAIN[d],) + extra_checks(d)


def _consts(**values) -> list:
    """Substitutions of the kernel's namespace-level constants."""
    src = SOURCE.read_text()
    out = []
    for name, value in values.items():
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        if m is None:
            raise AssertionError(f"constant {name} not in the source")
        out.append((m.group(0), f"constexpr int {name} = {value};"))
    return out


_TRACE_DECL = """
// trace: thread 0 of each block stamps clock64 at each barrier, and
// globaltimer at the block's start and end
__device__ long long g_flash_trace[1024][48];
__device__ __forceinline__ void trace_mark(int& n) {
  if (threadIdx.x == 0 && n < 46) g_flash_trace[blockIdx.x][n++] = clock64();
}
__device__ __forceinline__ void trace_time(int slot) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) g_flash_trace[blockIdx.x][slot] = t;
}
namespace {
"""
_TRACE_TAIL = """
extern "C" int flash_trace_read(long long* host) {
  return cudaMemcpyFromSymbol(host, g_flash_trace, sizeof(g_flash_trace));
}
"""


def _trace() -> list:
    marks = ("    __syncthreads();         // (A) K(t) and Q shown; P, alpha "
             "of t - 1 read",
             "    __syncthreads();         // (B) every slice's partial scores"
             " written",
             "    __syncthreads();         // (C) P, alpha and V(t) shown")
    subs = [("namespace {\n", _TRACE_DECL),
            ("  // round r's item: heaviest first, in snake order over the "
             "blocks so that",
             "  int ntr = 0;\n  trace_time(46);\n  trace_mark(ntr);\n"
             "  // round r's item: heaviest first, in snake order over the "
             "blocks so that"),
            ("    if (last) {              // the item is done",
             "    trace_mark(ntr);\n    if (last) {              // the item is"
             " done"),
            ("      if (!has_next) break;",
             "      trace_mark(ntr);\n      if (!has_next) { trace_time(47); "
             "break; }")]
    subs += [(m, m + "\n    trace_mark(ntr);") for m in marks]
    return subs


def trace_report(lib) -> None:
    """Per block: its start and end on the global clock (us from the
    first start), and the clock64 deltas between consecutive stamps (A, B,
    C, after P V, after the stores at an item's end)."""
    arr = (ctypes.c_longlong * (1024 * 48))()
    if lib.flash_trace_read(ctypes.addressof(arr)) != 0:
        raise RuntimeError("flash_trace_read failed")
    rows = [r for r in (list(arr[48 * b:48 * b + 48]) for b in range(1024))
            if r[46]]
    t0 = min(r[46] for r in rows)
    ends = [(r[47] - t0) / 1e3 for r in rows]
    print(f"trace: block ends (us after the first start) min {min(ends):.2f}"
          f" median {statistics.median(ends):.2f} max {max(ends):.2f}; "
          f"starts max {max((r[46] - t0) / 1e3 for r in rows):.2f}",
          flush=True)
    for b in sorted({0, len(rows) // 3, 2 * len(rows) // 3, len(rows) - 1}):
        r = rows[b]
        n = next((i for i in range(46) if i > 0 and r[i] == 0), 46)
        print(f"trace block {b}: end {ends[b]:.2f} us; cycles between stamps "
              + " ".join(str(r[i] - r[i - 1]) for i in range(1, n)),
              flush=True)


VARIANTS = {
    "as_built": [],
    # one block an item, not persistent
    "one_item_a_block": [(
        "const int blocks = min(a.n_items, resident_group_blocks<D>);",
        "const int blocks = a.n_items;")],
    # 256 threads: 5 rows x 16 columns of O and 5 x 8 scores a thread
    "threads_256": lambda d: _consts(kGThreads=256, kGKeysPerThread=8),
    # 40 rows, 16-key tiles, 128 threads, two blocks an SM
    "rows_40": lambda d: _consts(kGThreads=128, kGRows=40, kGBK=16,
                               kGBlocksPerSM=2),
    # 5 heads x 16 positions an item, the group in two chunks
    "positions_16": lambda d: _consts(kGMinPositions=16),
    # the score FMAs of one key's float4 back to back (the same sums in the
    # same order; the source orders them component by component)
    "score_chains": [(
        """float4 kv[KT];
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
          for (int j = 0; j < KT; ++j) sacc[i][j] = fmaf(qv[i].w, kv[j].w, sacc[i][j]);""",
        """#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + j * D + d);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            sacc[i][j] = fmaf(qv[i].x, kv.x, sacc[i][j]);
            sacc[i][j] = fmaf(qv[i].y, kv.y, sacc[i][j]);
            sacc[i][j] = fmaf(qv[i].z, kv.z, sacc[i][j]);
            sacc[i][j] = fmaf(qv[i].w, kv.w, sacc[i][j]);
          }
        }""")],
    "score_unroll_2": [("#pragma unroll 1\n      for (int d = 0;",
                        "#pragma unroll 2\n      for (int d = 0;")],
    "pv_unroll_2": [("#pragma unroll 1\n      for (int j = j_lo; j < j_hi; j += 4) {",
                     "#pragma unroll 2\n      for (int j = j_lo; j < j_hi; j += 4) {")],
    # Q rows unpadded, one bulk copy a head; each lane starts its D loop
    # at its own float4 (rg % 8) so a quarter warp still reads 8 bank groups
    "q_head_copies": [
        ("  static constexpr int kQStride = D + 4;",
         "  static constexpr int kQStride = D;"),
        ("""    for (int r = copier; r < R; r += 32 * G::kCopyWarps) {
      const int64_t row = group_row(a, it, r);
      if (row >= 0)
        bulk_copy(smem_u32(qs + r * G::kQStride), q + row * D, D * 4, q_bar);
    }""", """    for (int hc = copier; hc < it.heads; hc += 32 * G::kCopyWarps)
      bulk_copy(smem_u32(qs + hc * a.positions * D),
                q + ((static_cast<int64_t>(it.b) * a.hq + it.h0 + hc) * a.sq
                     + it.p0) * D, it.n_pos * D * 4, q_bar);"""),
        ("""#pragma unroll 1
      for (int d = 0; d < G::kSliceD; d += 4) {
        float4 qv[RT];""", """#pragma unroll 1
      for (int step = 0; step < G::kSliceD / 4; ++step) {
        const int d = 4 * ((step + rg) % (G::kSliceD / 4));
        float4 qv[RT];""")],
    "trace": lambda d: _trace(),
    "skip_q_copies": [
        ("mbar_expect(q_bar, it.heads * it.n_pos * D * 4);",
         "mbar_expect(q_bar, 0);"),
        ("      if (row >= 0)\n        bulk_copy(",
         "      if (row < -1)\n        bulk_copy(")],
    "skip_kv_copies": [
        ("mbar_expect(bar, rows * D * 4);\n      bulk_copy(smem_u32(dst), base",
         "mbar_expect(bar, 0);\n      if (rows < 0) bulk_copy(smem_u32(dst), base")],
    # no stores, but a condition the compiler cannot fold keeps P V alive
    "skip_stores": [("        if (row < 0) continue;",
                     "        if (row < 0 || a.scale == a.scale) continue;")],
    "skip_scores": [(
        "for (int d = 0; d < G::kSliceD; d += 4) {",
        "for (int d = 0; d < 0; d += 4) {")],
    # one operand's shared loads in a product replaced by register values
    # (no shared-memory traffic for it): how much that operand's loads cost
    "skip_score_q_loads": [(
        "qv[i] = *reinterpret_cast<const float4*>(qt + i * G::kRG * G::kQStride + d);",
        "qv[i] = make_float4(__int_as_float(d + i), __int_as_float(d), "
        "__int_as_float(i), __int_as_float(d - i));")],
    "skip_score_k_loads": [(
        "kv[j] = *reinterpret_cast<const float4*>(kt + j * D + d);",
        "kv[j] = make_float4(__int_as_float(d + j), __int_as_float(d), "
        "__int_as_float(j), __int_as_float(d - j));")],
    "skip_softmax": [("    if (s_warp) {", "    if (s_warp && tid < 0) {")],
    "skip_exps": [("        alpha = expf(m - m_new);", "        alpha = 1.0f;"),
                  ("expf(s[jj] - m_new)", "(s[jj] - m_new)")],
    "skip_pv": [("for (int j = j_lo; j < j_hi; j += 4) {",
                 "for (int j = j_lo; j < j_lo; j += 4) {")],
    "skip_pv_v_loads": [(
        "vv[c] = *reinterpret_cast<const float4*>(vt + (j + jj) * D + 4 * G::kCG * c);",
        "vv[c] = make_float4(__int_as_float(j + jj), __int_as_float(c), "
        "__int_as_float(j), __int_as_float(jj - c));")],
}


def _tc_shape(d: int, **values) -> list:
    """Substitutions of TcShape's constants at head dim d (the other head
    dims keep theirs)."""
    src = SOURCE.read_text()
    out = []
    for name, value in values.items():
        m = re.search(rf"static constexpr (int|bool) {name} = ([^;]+);", src)
        if m is None:
            raise AssertionError(f"TcShape::{name} not in the source")
        out.append((m.group(0), f"static constexpr {m.group(1)} {name} = "
                                f"D == {d} ? {value} : ({m.group(2)});"))
    return out


# P V's A fragment: from S's C fragment in place with P V's key index
# permuted (as built: column t is key 2t, t + 4 is 2t + 1, and V's B
# fragment reads rows 2t and 2t + 1), or in the unpermuted layout (V rows
# t and t + 4) through a per-warp [16][12] shared tile or by shuffles
_P_IN_PLACE = """          uint32_t ph[4], pl[4];
          tc_split(pc[j][0], ph[0], pl[0]);
          tc_split(pc[j][2], ph[1], pl[1]);
          tc_split(pc[j][1], ph[2], pl[2]);
          tc_split(pc[j][3], ph[3], pl[3]);"""
_V_ROWS_T = [
    ("+ 2 * tq * RS + g;", "+ tq * RS + g;"),
    ("tc_split(vj[RS + 8 * n], bh[1], bl[1]);",
     "tc_split(vj[4 * RS + 8 * n], bh[1], bl[1]);")]
_P_SMEM = """          float* pw = p_tile + g * 12 + 2 * tq;
          *reinterpret_cast<float2*>(pw) = make_float2(pc[j][0], pc[j][1]);
          *reinterpret_cast<float2*>(pw + 8 * 12) = make_float2(pc[j][2], pc[j][3]);
          __syncwarp();
          const float* pr = p_tile + g * 12 + tq;
          uint32_t ph[4], pl[4];
          tc_split(pr[0], ph[0], pl[0]);
          tc_split(pr[8 * 12], ph[1], pl[1]);
          tc_split(pr[4], ph[2], pl[2]);
          tc_split(pr[8 * 12 + 4], ph[3], pl[3]);
          __syncwarp();"""
# lane 4g + t wants P[g][t] and P[g][t + 4]: element t & 1 of lanes
# 4g + t / 2 and 4g + t / 2 + 2 (rows g + 8 likewise)
_P_SHUFFLES = """          const int src0 = (lane & ~3) | (tq >> 1);
          float x[2][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[0][e] = __shfl_sync(0xffffffffu, pc[j][e], src0);
            x[1][e] = __shfl_sync(0xffffffffu, pc[j][e], src0 + 2);
          }
          const int odd = tq & 1;
          uint32_t ph[4], pl[4];
          tc_split(odd ? x[0][1] : x[0][0], ph[0], pl[0]);
          tc_split(odd ? x[0][3] : x[0][2], ph[1], pl[1]);
          tc_split(odd ? x[1][1] : x[1][0], ph[2], pl[2]);
          tc_split(odd ? x[1][3] : x[1][2], ph[3], pl[3]);"""
_LO_TERMS = """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh[0]), "r"(bh[1]));
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(bl[0]), "r"(bl[1]));
"""
_HI_TERM = """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(bh[0]), "r"(bh[1]));
"""
# each k-step's three products summed from zero on the tensor cores, then
# added to the accumulator in f32 (rounded to nearest)
_SUM_PER_STEP = ("  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
                 + (_LO_TERMS + _HI_TERM).replace("c[", "z[")
                 + "#pragma unroll\n"
                 "  for (int e = 0; e < 4; ++e) c[e] += z[e];\n")
_SKIP_COPIES = [
    ("if (lane == 0) mbar_expect(bar, rows * kRowBytes);",
     "if (lane == 0) mbar_expect(bar, 0);"),
    ("for (int r = lane; r < rows; r += 32)\n        bulk_copy(",
     "for (int r = lane; r < 0; r += 32)\n        bulk_copy("),
    ("if (lane == 0) mbar_expect(q_full, it.heads * it.n_pos * kRowBytes);",
     "if (lane == 0) mbar_expect(q_full, 0);"),
    ("if (row >= 0) bulk_copy(smem_u32(qs + r * RS)",
     "if (row < -1) bulk_copy(smem_u32(qs + r * RS)")]

TC_VARIANTS = {
    "as_built": [],
    "bk_64": lambda d: _consts(kTcBK=64),
    "bk_16": lambda d: _consts(kTcBK=16),
    "slots_2": lambda d: _tc_shape(d, kSlots=2),
    "slots_3": lambda d: _tc_shape(d, kSlots=3),
    "slots_4": lambda d: _tc_shape(d, kSlots=4),
    # __launch_bounds__' blocks an SM: the register cap ptxas works to
    "min_blocks_1": lambda d: _tc_shape(d, kBlocksPerSM=1),
    "min_blocks_2": lambda d: _tc_shape(d, kBlocksPerSM=2),
    "min_blocks_4": lambda d: _tc_shape(d, kBlocksPerSM=4),
    # the register cap set directly, above __launch_bounds__' 168 (two
    # blocks) and 128 (three): does a block of 160 threads fit the SM as
    # often at 200 (or 136) registers?
    "maxnreg": [("__global__ void __launch_bounds__(kTcThreads, TcShape<D>::kBlocksPerSM)",
                 "__global__ void __launch_bounds__(kTcThreads) "
                 "__maxnreg__(D == 96 ? 136 : 200)")],
    "p_smem": [
        (_P_IN_PLACE, _P_SMEM),
        ("+ kSlots * kSlotElems;",
         "+ kSlots * kSlotElems + kTcWarps * 16 * 12;"),
        ("  const int g = lane >> 2;\n",
         "  const int g = lane >> 2;\n"
         "  float* p_tile = reinterpret_cast<float*>(ring + S * T::kSlotElems)"
         " + warp * 16 * 12;\n")]
        + _V_ROWS_T,
    "p_shuffles": [(_P_IN_PLACE, _P_SHUFFLES)] + _V_ROWS_T,
    "sum_per_step": [(_LO_TERMS + _HI_TERM, _SUM_PER_STEP)],
    # hi by cvt.rna.tf32.f32 (the same rounding, more instructions), by
    # truncation (one LOP3), and lo rounded to TF32 too (a second cvt)
    "split_cvt": [("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                   'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));')],
    "split_rz": [("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                  "hi = __float_as_uint(x) & 0xffffe000u;")],
    "lo_rounded": [(
        "lo = __float_as_uint(x - __uint_as_float(hi));",
        'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')],
    # scores summed in the tensor core's accumulator, not a pair at a time
    "s_sum_in_mma": [("""            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            tc_mma3(z, ah, al, bh, bl);
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += z[e];""",
                      "            tc_mma3(sc[j], ah, al, bh, bl);")],
    # each warp scales its Q rows in shared memory once an item, not at
    # every load
    "q_prescaled": [
        ("    mbar_wait(q_full, round & 1);\n",
         "    mbar_wait(q_full, round & 1);\n"
         "    for (int e = lane; e < 16 * (D / 4); e += 32) {\n"
         "      float4* x = reinterpret_cast<float4*>(qs + (16 * warp + e / (D / 4)) * RS) + e % (D / 4);\n"
         "      const float4 y = *x;\n"
         "      *x = make_float4(__fmul_rn(y.x, a.scale), __fmul_rn(y.y, a.scale),\n"
         "                       __fmul_rn(y.z, a.scale), __fmul_rn(y.w, a.scale));\n"
         "    }\n"
         "    fence_proxy_async();\n"
         "    __syncwarp();\n")]
        + [(f"__fmul_rn({x}, a.scale)", x)
           for x in ("xa.x", "xb.x", "xa.y", "xb.y")],
    "s_unroll_1": [("#pragma unroll 2\n        for (int d0 = 0;",
                    "#pragma unroll 1\n        for (int d0 = 0;")],
    "s_unroll_4": [("#pragma unroll 2\n        for (int d0 = 0;",
                    "#pragma unroll 4\n        for (int d0 = 0;")],
    # S scored only in the 8-key blocks the warp can see, a branch each (as
    # built at 192), or every block of a tile the warp sees (at 96, 128)
    "score_blocks_apart": lambda d: _tc_shape(d, kScoreWholeTile="false"),
    "score_whole_tile": lambda d: _tc_shape(d, kScoreWholeTile="true"),
    # one TF32 pass (hi.hi): wrong by about 1e-3, only timed
    "skip_lo_terms": [(_LO_TERMS, "")],
    # K or V taken as hi with lo = 0: what their splits cost
    "skip_k_split": [(f"tc_split(y.{c}, bh[{i}], bl[{i}]);",
                      f"bh[{i}] = __float_as_uint(y.{c}); bl[{i}] = 0;")
                     for c, i in (("x", 0), ("y", 1))],
    "skip_v_split": [
        ("tc_split(vj[8 * n], bh[0], bl[0]);",
         "bh[0] = __float_as_uint(vj[8 * n]); bl[0] = 0;"),
        ("tc_split(vj[RS + 8 * n], bh[1], bl[1]);",
         "bh[1] = __float_as_uint(vj[RS + 8 * n]); bl[1] = 0;")],
    # no products at all (nor the loads and splits that feed them)
    "skip_mma": [(_LO_TERMS + _HI_TERM, "")],
    # no copies: the consumers work on whatever shared memory holds
    "skip_copies": _SKIP_COPIES,
    # no stores, but a condition the compiler cannot fold keeps P V alive
    "skip_stores": [("    if (row_a >= 0) {\n", "    if (row_a >= 0 && a.scale != a.scale) {\n"),
                    ("    if (row_b >= 0) {\n", "    if (row_b >= 0 && a.scale != a.scale) {\n")],
}


def _bf16_part(src: str) -> tuple:
    """The source cut into (before, the bf16 kernel's part, after)."""
    i = src.index(BF16_BEGIN)
    j = src.index(BF16_END, i)
    return src[:i], src[i:j], src[j:]


def _bf_shape(d: int, **values) -> list:
    """Substitutions of Bf16Shape's constants at head dim d (the other head
    dims keep theirs)."""
    part = _bf16_part(SOURCE.read_text())[1]
    out = []
    for name, value in values.items():
        m = re.search(rf"static constexpr (int|bool) {name} = ([^;]+);", part)
        if m is None:
            raise AssertionError(f"Bf16Shape::{name} not in the source")
        out.append((m.group(0), f"static constexpr {m.group(1)} {name} = "
                                f"D == {d} ? {value} : ({m.group(2)});"))
    return out


def _bf16_pass(operand: str, acc: str = "c") -> str:
    """One mma.sync of the bf16 helpers, as written in the source."""
    return ('  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, '
            '%1, %2, %3}, "\n'
            '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
            f'      : "+f"({acc}[0]), "+f"({acc}[1]), "+f"({acc}[2]), '
            f'"+f"({acc}[3])\n'
            f'      : "r"({operand}[0]), "r"({operand}[1]), "r"({operand}[2]), '
            f'"r"({operand}[3]), "r"(b0), "r"(b1));\n')


_BF16_EXPS = [(f"{x} = expf({y});", f"{x} = ({y});") for x, y in (
    ("alpha[h]", "m[h] - mu[h]"),
    ("sc[j][e]", "sc[j][e] - mu[e >> 1]"))]

_BF16_TRACE = [
    ("template <int D>\nstruct Bf16Shape {",
     _TRACE_DECL.replace("namespace {\n", "")
     + "template <int D>\nstruct Bf16Shape {"),
    ("  __syncthreads();\n\n  // round r's item, in snake order",
     "  __syncthreads();\n  int ntr = 0;\n  trace_time(46);\n  trace_mark(ntr);\n"
     "\n  // round r's item, in snake order"),
    ("    if (index >= a.n_items) break;\n    const GroupItem it = group_item(a, index);\n"
     "    const int t_first = it.k_begin / BK;\n    const int t_end = (it.k_end + BK - 1) / BK;\n"
     "    // the positions",
     "    if (index >= a.n_items) { trace_time(47); break; }\n"
     "    const GroupItem it = group_item(a, index);\n"
     "    const int t_first = it.k_begin / BK;\n    const int t_end = (it.k_end + BK - 1) / BK;\n"
     "    // the positions")]
_BF16_TRACE += [(m, m + "trace_mark(ntr);\n") for m in (
    "    mbar_wait(q_full, round & 1);\n", "      scores(t, p);\n",
    "      softmax(t, p);\n", "      weigh(t, p);\n",
    "    __syncwarp();                                 // os is rewritten next item\n")]

BF16_VARIANTS = {
    "as_built": [],
    # clock stamps of consumer warp 0's lane 0: the block's start, Q landed,
    # after each tile's scores, softmax and P V, after an item's stores
    "trace": _BF16_TRACE,
    # (q head, position) rows an item: 16 a consumer warp
    "warps_2": lambda d: _bf_shape(d, kWarps=2),
    "warps_8": lambda d: _bf_shape(d, kWarps=8),
    "bk_32": lambda d: _bf_shape(d, kBK=32),
    "bk_64": lambda d: _bf_shape(d, kBK=64),
    "bk_128": lambda d: _bf_shape(d, kBK=128),
    "slots_2": lambda d: _bf_shape(d, kSlots=2),
    "slots_4": lambda d: _bf_shape(d, kSlots=4),
    "slots_6": lambda d: _bf_shape(d, kSlots=6),
    "slots_8": lambda d: _bf_shape(d, kSlots=8),
    # __launch_bounds__' blocks an SM: the register cap ptxas works to
    "min_blocks_2": lambda d: _bf_shape(d, kBlocksPerSM=2),
    "min_blocks_3": lambda d: _bf_shape(d, kBlocksPerSM=3),
    "min_blocks_4": lambda d: _bf_shape(d, kBlocksPerSM=4),
    "min_blocks_5": lambda d: _bf_shape(d, kBlocksPerSM=5),
    "min_blocks_6": lambda d: _bf_shape(d, kBlocksPerSM=6),
    "min_blocks_8": lambda d: _bf_shape(d, kBlocksPerSM=8),
    "bk_16": lambda d: _bf_shape(d, kBK=16),
    # S's k-steps unrolled one, two or all at a time (more products in
    # flight, more registers)
    "s_unroll_1": lambda d: _bf_shape(d, kSUnroll=1),
    "s_unroll_2": lambda d: _bf_shape(d, kSUnroll=2),
    "s_unroll_all": lambda d: _bf_shape(d, kSUnroll=d // 16),
    # P V's 8-column blocks two at a time
    "pv_unroll_1": [("#pragma unroll\n          for (int n = 0; n < D / 16; ++n) {",
                     "#pragma unroll 1\n          for (int n = 0; n < D / 16; ++n) {")],
    # the producer copies an item's first K tile before its Q
    "k_first": [("        if (t == t_first) {\n          // the item's Q rows",
                 "        if (t == t_first) load_tile(k, it.bkv, t);\n"
                 "        if (t == t_first) {\n          // the item's Q rows"),
                ("        load_tile(k, it.bkv, t);\n        load_tile(v, it.bkv, t);",
                 "        if (t != t_first) load_tile(k, it.bkv, t);\n"
                 "        load_tile(v, it.bkv, t);")],
    # P in one bf16 piece (hi V only): another function, timed only
    "skip_lo_pass": [(_bf16_pass("pl"), "")],
    # no products of S, or of P V (their loads stay: ldmatrix is volatile)
    "skip_qk": [(_bf16_pass("a", "z"), "")],
    "skip_pv": [(_bf16_pass("pl") + _bf16_pass("ph"), "")],
    # no exponentials: the softmax's subtractions and sums only
    "skip_exps": _BF16_EXPS,
    # P's pieces as raw bits, no rounding or subtraction
    "skip_split": [(
        "  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);\n"
        "  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x, __low2float(h)),\n"
        "                                                 __fsub_rn(y, __high2float(h)));\n"
        "  hi = *reinterpret_cast<const uint32_t*>(&h);\n"
        "  lo = *reinterpret_cast<const uint32_t*>(&l);\n",
        "  hi = __float_as_uint(x);\n  lo = __float_as_uint(y);\n")],
    "skip_copies": _SKIP_COPIES,
    # the output times 1 / l, without quotient_rn's correction
    "skip_div": [("  return __fmaf_rn(__fmaf_rn(-q, d, x), inv, q);", "  return q;")],
    # the output divided by l, one division a value
    "divide": [("store2(op + 8 * n, quotient_rn(acc[n][2 * h], den, inv),\n"
                "               quotient_rn(acc[n][2 * h + 1], den, inv));",
                "store2(op + 8 * n, acc[n][2 * h] / den, acc[n][2 * h + 1] / den);")],
    # no stores to device memory (the staging in shared memory stays)
    "skip_stores": [("      if (row >= 0)\n        reinterpret_cast<uint4*>(o + row * D)",
                     "      if (row < -1)\n        reinterpret_cast<uint4*>(o + row * D)")],
}


def variant_source(name: str, baseline, variants: dict, d: int) -> str:
    if name == "baseline":
        return Path(baseline).read_text()
    # "a+b": the substitutions of a, then those of b
    subs = []
    for part_name in name.split("+"):
        part_subs = variants[part_name]
        subs += part_subs(d) if callable(part_subs) else part_subs
    before, part, after = _bf16_part(SOURCE.read_text())
    # the bf16 variants change the bf16 kernel's part, the others the rest
    mark = "\x00"
    if variants is BF16_VARIANTS:
        src, kept = part, before + mark + after
    else:
        src, kept = before + mark + after, part
    for old, new in subs:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} found {src.count(old)} "
                                 "times in the source")
        src = src.replace(old, new)
    src = (kept.replace(mark, src) if variants is BF16_VARIANTS
           else src.replace(mark, kept))
    return src + _TRACE_TAIL if "trace" in name.split("+") else src


def ptxas_summary(log: str, d: int, bf16: bool = False) -> dict:
    """Registers and spill bytes of the head_dim-d kernel (at 256 the group
    kernel, or the split kernel of an older source; at 96 and 192 the tc
    kernel, or an older source's small or group kernel; in bf16 the bf16
    kernel, or an older source's bf16 small or tc instance)."""
    pattern = (rf"flash_fwd_bf16_kernelILi{d}E|"
               rf"flash_fwd_(small|tc)_kernelILi{d}E13__nv_bfloat16" if bf16
               else rf"flash_fwd_(tc|group|small|split)_kernelILi{d}E[fE]")
    out, inside = {}, False
    for line in log.splitlines():
        if "Function properties for" in line:
            inside = bool(re.search(pattern, line))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and inside:
            out.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and inside:
            out["registers"] = int(m.group(1))
            inside = False
    return out


def build(names, baseline, d: int, variants: dict, bf16: bool) -> dict:
    """One nvcc per variant, all started together (the port's flags plus
    -Xptxas -v); returns name -> (library path, ptxas summary)."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}_{d}.cu"
        cu.write_text(variant_source(name, baseline, variants, d))
        lib = OUT / f"lib{name}_{d}.so"
        procs[name] = (lib, subprocess.Popen(
            [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, ptxas_summary(log, d, bf16))
    return out


def attributes(lib, d: int, bf16: bool) -> dict:
    """The head_dim-d kernel's registers, shared memory and blocks an SM,
    as the variant's library reports them on this card."""
    fn = lib.flash_attention_bf16_attributes if bf16 \
        else lib.flash_attention_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 8)()
    if fn(d, ctypes.addressof(info)) != 0:
        raise RuntimeError("flash_attention_attributes failed")
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads", "rows", "key_tile")
    return dict(zip(keys, info))


def _option(args: list, flag: str, default):
    """The value after `flag` in args (removed from them), or default."""
    if flag not in args:
        return default
    i = args.index(flag)
    value = args[i + 1]
    del args[i:i + 2]
    return value


def bf16_ulps(torch, chip_smoke, got, ref) -> float:
    """chip_smoke's `within_bf16_ulp` reading without its raise: the
    largest |got - ref| in bf16 ulps of |ref| (or of max|ref| / 256)."""
    ref = ref.float()
    tol = chip_smoke.bf16_ulp(torch, torch.clamp_min(
        ref.abs(), float(ref.abs().max()) / 256))
    return float(((got.float() - ref).abs() / tol).max())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    args = sys.argv[1:]
    baseline = _option(args, "--baseline", None)
    dtype_name = _option(args, "--dtype", "f32")
    if dtype_name not in ("f32", "bf16"):
        raise SystemExit(f"--dtype takes f32 or bf16, not {dtype_name}")
    bf16 = dtype_name == "bf16"
    d = int(_option(args, "--head-dim", 64 if bf16 else 256))
    if bf16:
        if d not in BF16_MAIN:
            raise SystemExit(f"--dtype bf16 --head-dim takes 64 or 128, "
                             f"not {d}")
        variants, main_case = BF16_VARIANTS, BF16_MAIN[d]
        # --main LABEL: one of BF16_TIMED's shapes as the main shape
        label = _option(args, "--main", None)
        if label is not None:
            qs, ks, causal = BF16_TIMED[d][label]
            main_case = (qs, ks, causal, None)
        # and non-causal over several key tiles
        checks = (main_case,) + extra_checks(d) + (
            ((2, 4, 150, d), (2, 4, 150, d), False, None),)
        dtype = torch.bfloat16
    elif d == 256:
        variants, main_case, checks = VARIANTS, MAIN, CHECKS
        dtype = torch.float32
    elif d in TC_MAIN:
        variants, main_case, checks = TC_VARIANTS, TC_MAIN[d], tc_checks(d)
        dtype = torch.float32
    else:
        raise SystemExit(f"--head-dim takes 256, 192, 128 or 96, not {d}")
    names = args or list(variants)
    if baseline is not None:
        names.append("baseline")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = build(names, baseline, d, variants, bf16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    inputs = []
    for qs, ks, causal, window in checks:
        q = torch.randn(qs, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(ks, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        inputs.append((q, k, v, causal, window, fa.attention_plain(
            q.float(), k.float(), v.float(), causal, window)))
    errors = {}
    if not bf16 and d != 256:
        # inputs x8 (scores x64): every f32 implementation, the plain
        # version included, is tens of times the 1e-5 gate from the exact
        # value here; printed against the f64 value, beside the plain
        # version's own
        qs = main_case[1][:1] + (8,) + main_case[1][2:]
        large = [8 * torch.randn(qs, generator=gen, device=dev)
                 for _ in range(3)]
        large_exact = chip_smoke.attention_f64(torch, *large)
        errors["plain"] = {"x8_vs_f64": chip_smoke.gate_share(
            fa.attention_plain(*large), large_exact)}
    if bf16:
        timed = {label: ([torch.randn(qs, generator=gen, device=dev)
                          .to(dtype)] + [torch.randn(ks, generator=gen,
                                                     device=dev).to(dtype)
                                         for _ in range(2)], causal)
                 for label, (qs, ks, causal) in BF16_TIMED[d].items()}
    else:
        timed = {label: ([torch.randn(qs, generator=gen, device=dev)] + [
                     torch.randn(ks, generator=gen, device=dev)
                     for _ in range(2)], True)
                 for label, (qs, ks) in TC_TIMED.get(d, {}).items()}
    plain_lib = fa._lib
    times = {name: [] for name in names}
    timed_ms = {label: {name: [] for name in names} for label in timed}
    attrs = {}
    for name in names + names[::-1]:
        lib = ctypes.CDLL(str(built[name][0]))
        attrs.setdefault(name, attributes(lib, d, bf16))
        fns = {}
        for dt, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            fn = getattr(lib, f"flash_attention_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[dt] = fn
        fa._lib = lambda fns=fns: fns
        if "skip_" not in name or name == "skip_lo_pass":
            gates = []
            for q, k, v, causal, window, want in inputs:
                got = fa.flash_attention_cuda(q, k, v, causal, window)
                torch.cuda.synchronize()
                if bf16:
                    gates.append(bf16_ulps(torch, chip_smoke, got, want))
                    if name == "skip_lo_pass":
                        continue
                    if not gates[-1] <= 1.0 or not torch.equal(
                            got, fa.flash_attention_cuda(q, k, v, causal,
                                                         window)):
                        raise AssertionError(
                            f"{name} {tuple(q.shape)} on {tuple(k.shape)}: "
                            f"{gates[-1]:.3f} bf16 ulp, or two calls differ")
                    continue
                if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                    err = float((got - want).abs().max())
                    raise AssertionError(f"{name} {tuple(q.shape)} on "
                                         f"{tuple(k.shape)}: max err {err}")
                gates.append(chip_smoke.gate_share(got, want))
            if bf16 and name not in errors:
                errors[name] = {"bf16_ulp": max(gates)}
                print(f"{name}: {errors[name]}", flush=True)
            elif name not in errors and d != 256:
                q, k, v = large
                errors[name] = {
                    "gate_share": max(gates),
                    "x8_vs_f64": chip_smoke.gate_share(fa.flash_attention_cuda(q, k, v),
                                            large_exact)}
                print(f"{name}: {errors[name]}", flush=True)
        q, k, v, causal, window, _ = inputs[0]
        ms = chip_smoke.device_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal, window))
        times[name].append(ms)
        print(f"{name}: device time {ms:.4f} ms", flush=True)
        if "trace" in name.split("+"):
            trace_report(ctypes.CDLL(str(built[name][0])))
        for label, (qkv, causal) in timed.items():
            ms = chip_smoke.device_ms(torch, lambda: fa.flash_attention_cuda(
                *qkv, causal))
            timed_ms[label][name].append(ms)
            print(f"{name}: {label} device time {ms:.4f} ms", flush=True)
    fa._lib = plain_lib
    for name in names:
        print(f"{name}: ptxas {built[name][1]}; {attrs[name]}", flush=True)
    print(json.dumps({"device": smi, "head_dim": d, "dtype": dtype_name,
                      "shape": [list(main_case[0]), list(main_case[1])],
                      "device_ms": {name: statistics.median(v)
                                    for name, v in times.items()},
                      "runs_ms": times,
                      "timed_runs_ms": {
                          label: {"shape": [list(t.shape) for t in qkv[:2]],
                                  "runs_ms": timed_ms[label]}
                          for label, (qkv, _) in timed.items()},
                      "ptxas": {name: built[name][1] for name in names},
                      "attributes": attrs, "errors": errors}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
