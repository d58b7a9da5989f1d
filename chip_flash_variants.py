#!/usr/bin/env python3
"""Where flash_attention's head_dim-256 time goes on one GPU, measured by
taking pieces away and by changing one design choice at a time.

    python3 chip_flash_variants.py [--baseline FILE.cu] [variant ...]

Each variant is src/repro_torch/kernels/csrc/flash_attention.cu with one or
more text substitutions (VARIANTS below; an anchor that no longer matches
the source raises), built with nvcc into build/flash_variants/ and called
through the port's own wrapper at recurrentgemma-2b's attention shape
(q [40,10,64,256] on k/v [40,1,64,256], causal, window 2048). `--baseline`
adds one more variant, "baseline": another flash_attention.cu built as it
is (an older version of the source, to time against in the same call).
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
Every variant runs twice, in the order given and then reversed, on the
same inputs. Printed per run: the device time of one call (its kernel's
self time under torch.profiler, mean of 20 calls); per variant, ptxas's
registers and spill bytes of the head_dim-256 kernel. Needs one CUDA
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
            ("  // round r's item: heaviest first",
             "  int ntr = 0;\n  trace_time(46);\n  trace_mark(ntr);\n"
             "  // round r's item: heaviest first"),
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
    "threads_256": lambda: _consts(kGThreads=256, kGKeysPerThread=8),
    # 40 rows, 16-key tiles, 128 threads, two blocks an SM
    "rows_40": lambda: _consts(kGThreads=128, kGRows=40, kGBK=16,
                               kGBlocksPerSM=2),
    # 5 heads x 16 positions an item, the group in two chunks
    "positions_16": lambda: _consts(kGMinPositions=16),
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
    "trace": _trace,
    "skip_q_copies": [
        ("mbar_expect(q_bar, it.heads * it.n_pos * D * 4);",
         "mbar_expect(q_bar, 0);"),
        ("      if (row >= 0)\n        bulk_copy(",
         "      if (row < -1)\n        bulk_copy(")],
    "skip_kv_copies": [
        ("mbar_expect(bar, rows * D * 4);", "mbar_expect(bar, 0);"),
        ("      bulk_copy(smem_u32(dst), base",
         "      if (rows < 0) bulk_copy(smem_u32(dst), base")],
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


def variant_source(name: str, baseline) -> str:
    if name == "baseline":
        return Path(baseline).read_text()
    subs = VARIANTS[name]
    subs = subs() if callable(subs) else subs
    src = SOURCE.read_text()
    if name == "trace":
        src += _TRACE_TAIL
    for old, new in subs:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} found {src.count(old)} "
                                 "times in the source")
        src = src.replace(old, new)
    return src


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of the head_dim-256 kernel (the group
    kernel, or the split kernel of an older source)."""
    out, inside = {}, False
    for line in log.splitlines():
        if "Function properties for" in line:
            inside = bool(re.search(r"flash_fwd_(group|split)_kernelILi256E",
                                    line))
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


def build(names, baseline) -> dict:
    """One nvcc per variant, all started together (the port's flags plus
    -Xptxas -v); returns name -> (library path, ptxas summary)."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(name, baseline))
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, ptxas_summary(log))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    args = sys.argv[1:]
    baseline = None
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline = args[i + 1]
        del args[i:i + 2]
    names = args or list(VARIANTS)
    if baseline is not None:
        names.append("baseline")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = build(names, baseline)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    inputs = []
    for qs, ks, causal, window in CHECKS:
        q = torch.randn(qs, generator=gen, device=dev)
        k, v = (torch.randn(ks, generator=gen, device=dev) for _ in range(2))
        inputs.append((q, k, v, causal, window,
                       fa.attention_plain(q, k, v, causal, window)))
    plain_lib = fa._lib
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        fn = ctypes.CDLL(str(built[name][0])).flash_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fa._lib = lambda fn=fn: fn
        if not name.startswith("skip_"):
            for q, k, v, causal, window, want in inputs:
                got = fa.flash_attention_cuda(q, k, v, causal, window)
                torch.cuda.synchronize()
                if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                    err = float((got - want).abs().max())
                    raise AssertionError(f"{name} {tuple(q.shape)} on "
                                         f"{tuple(k.shape)}: max err {err}")
        q, k, v, causal, window, _ = inputs[0]
        ms = chip_smoke.device_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal, window))
        times[name].append(ms)
        print(f"{name}: device time {ms:.4f} ms", flush=True)
        if name == "trace":
            trace_report(ctypes.CDLL(str(built[name][0])))
    fa._lib = plain_lib
    for name in names:
        print(f"{name}: ptxas {built[name][1]}", flush=True)
    print(json.dumps({"device": smi, "shape": [list(MAIN[0]), list(MAIN[1])],
                      "device_ms": {name: statistics.median(v)
                                    for name, v in times.items()},
                      "runs_ms": times,
                      "ptxas": {name: built[name][1] for name in names}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
