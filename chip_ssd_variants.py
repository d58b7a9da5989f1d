#!/usr/bin/env python3
"""Where ssd_scan's time goes on one GPU, measured by taking pieces away.

    python3 chip_ssd_variants.py [variant ...]

Each variant is src/repro_torch/kernels/csrc/ssd_scan.cu with one or two
text substitutions (VARIANTS below), built with nvcc into build/
ssd_variants/ and called through the port's own wrapper at the main
path's shape (full mamba2-370m in training: B 40, S 64, H 32, P 64,
N 128, chunk 64, y only). Variants that change a design choice (heads per
block, blocks an SM, the programmatic dependent launch, the product loop's
unroll) are held against `ssd_plain` to 2e-5·max|ref| first; `skip_*`
variants leave a phase out, compute a wrong y by construction and are
only timed: what they save is that phase's share of the call. Every
variant runs twice, in the order given and then reversed, on the same
inputs. Printed per run: the device span of one call (first kernel's start
to last kernel's end, median of 20 calls under torch.profiler) and each
kernel's own device time; per variant and kernel, ptxas's registers and
spill bytes, and the spill instructions in the SASS (`cuobjdump -sass`)
with how many of them sit in an innermost loop that does FMAs. Needs one
CUDA device and nvcc; exits non-zero without either.
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
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
OUT = ROOT / "build" / "ssd_variants"
MAIN = (40, 64, 32, 64, 128, 64)                # B, S, H, P, N, chunk

_PRODUCT = "#pragma unroll 1\n        for (int j = 0; j < j_end; ++j) {"
_GROUP_FROM = """  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const float a_h = a[h];"""


def _heads_per_block(g: int) -> list:
    """G heads of one batch row a block, one after the other (the
    stateful instance keeps one)."""
    return [(_GROUP_FROM, f"""  constexpr int kGroup = kState ? 1 : {g};
  const int n_groups = (H + kGroup - 1) / kGroup;
  const int b = blockIdx.x / n_groups;
  const int h_end = min(H, (blockIdx.x % n_groups + 1) * kGroup);
  for (int h = (blockIdx.x % n_groups) * kGroup; h < h_end; ++h) {{
  const int bh = b * H + h;
  const float a_h = a[h];"""),
            ("}\n\nint smem_bytes", "}\n}\n\nint smem_bytes"),
            ("  cfg.gridDim = dim3(batch * heads);",
             f"  cfg.gridDim = dim3(batch * (state ? heads : "
             f"(heads + {g} - 1) / {g}));")]


VARIANTS = {
    "as_built": [],
    "heads_per_block_2": _heads_per_block(2),
    "heads_per_block_4": _heads_per_block(4),
    "blocks_per_sm_3": [("kState ? 2 : 4", "kState ? 2 : 3")],
    "blocks_per_sm_5": [("kState ? 2 : 4", "kState ? 2 : 5")],
    "no_dependent_launch": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "product_unroll_4": [(_PRODUCT, _PRODUCT.replace("unroll 1",
                                                     "unroll 4"))],
    "skip_product": [(
        "const int j_end = j0 == i0 ? min(rows_j, (ty | 1) * 4 + 4) "
        ": rows_j;", "const int j_end = 0;")],
    "skip_decay": [(
        "auto build_m = [&](int i0, int j0, int rows_i, int rows_j) {\n"
        "#pragma unroll 1\n    for (int k = 0; k < kMGroups; ++k) {",
        "auto build_m = [&](int i0, int j0, int rows_i, int rows_j) {\n"
        "#pragma unroll 1\n    for (int k = 0; k < 0; ++k) {")],
    "skip_copies": [
        ("    if (!vec) return;\n#pragma unroll\n"
         "    for (int k = 0; k < kXGroups; ++k) {",
         "    if (!vec) return;\n#pragma unroll\n"
         "    for (int k = 0; k < 0; ++k) {"),
        ("int rows_j) {\n#pragma unroll\n"
         "    for (int k = 0; k < kMGroups; ++k) {",
         "int rows_j) {\n#pragma unroll\n    for (int k = 0; k < 0; ++k) {")],
    "skip_cumsum": [("    if (tid == 0) {\n      float run = -0.0f;",
                     "    if (tid < 0) {\n      float run = -0.0f;")],
    "skip_cb_product": [("    for (int n = 0; n < N; ++n) {\n"
                         "      const float bv",
                         "    for (int n = 0; n < 0; ++n) {\n"
                         "      const float bv")],
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} found {src.count(old)} "
                                 "times in the source")
        src = src.replace(old, new)
    return src


def build(names) -> dict:
    """One nvcc per variant, all started together (the port's flags plus
    -Xptxas -v); returns name -> (library path, ptxas summary)."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(name))
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
        summary = ptxas_summary(log)
        sass = subprocess.run(
            [str(Path(kbuild.nvcc_path()).with_name("cuobjdump")), "-sass",
             str(lib)], capture_output=True, text=True, check=True).stdout
        for kernel, spills in sass_spills(sass).items():
            summary.setdefault(kernel, {}).update(spills)
        out[name] = (lib, summary)
    return out


def sass_spills(sass: str) -> dict:
    """kernel -> spill instructions (STL, LDL) in its SASS, and how many of
    them lie in an innermost loop that holds FFMAs (a backward branch's
    range with no other loop inside it)."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(ssd_cb_kernel|ssd_kernelILb[01])", func.split("\n")[0])
        if not m:
            continue
        kernel = {"ssd_cb_kernel": "ssd_cb_kernel",
                  "ssd_kernelILb0": "ssd_kernel<false>",
                  "ssd_kernelILb1": "ssd_kernel<true>"}[m.group(1)]
        code = [(int(a, 16), text) for a, text in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        loops = [(int(t, 16), a) for a, text in code
                 for t in re.findall(r"BRA (0x[0-9a-f]+)", text)
                 if int(t, 16) < a]
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
                            for lo2, hi2 in loops)]
        spill = [a for a, text in code if re.search(r"\b(STL|LDL)\b", text)]
        hot = [(lo, hi) for lo, hi in inner
               if any("FFMA" in t for a, t in code if lo <= a <= hi)]
        out[kernel] = {
            "sass_stl": sum(bool(re.search(r"\bSTL\b", t)) for _, t in code),
            "sass_ldl": sum(bool(re.search(r"\bLDL\b", t)) for _, t in code),
            "spills_in_fma_loops": sum(any(lo <= a <= hi for lo, hi in hot)
                                       for a in spill)}
    return out


def ptxas_summary(log: str) -> dict:
    """kernel -> registers and spill bytes, from nvcc -Xptxas -v output."""
    names = {"ssd_cb_kernel": "ssd_cb_kernel",
             "ssd_kernelILb0": "ssd_kernel<false>",
             "ssd_kernelILb1": "ssd_kernel<true>"}
    summary, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?"
                      r"(ssd_cb_kernel|ssd_kernelILb[01])", line)
        if m:
            kernel = names[m.group(1)]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            summary[kernel] = {"spill_stores": int(m.group(1)),
                               "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            summary[kernel]["registers"] = int(m.group(1))
    return summary


def kernel_times(torch, fn, reps: int = 20) -> dict:
    """Each kernel's own device time per call (mean over reps calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"ssd_\w+(<\w+>)?", e.key).group(0):
            e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "ssd_" in e.key}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ssd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import ssd_scan

    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = build(names)
    dev = torch.device("cuda")
    bsz, s, h, p, n, chunk = MAIN
    gen = torch.Generator(device=dev).manual_seed(5)
    args = chip_smoke.ssd_inputs(torch, dev, gen, bsz, s, h, p, n, False)
    y_ref, _ = ssd_scan.ssd_plain(*args, chunk)
    ref = float(y_ref.abs().max())
    plain_lib = ssd_scan._lib
    spans = {name: [] for name in names}
    for name in names + names[::-1]:
        fn = ctypes.CDLL(str(built[name][0])).ssd_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ssd_scan._lib = lambda fn=fn: fn
        call = lambda: ssd_scan.ssd_scan_cuda(  # noqa: E731
            *args, chunk, want_state=False)
        if not name.startswith("skip_"):
            err = float((call()[0] - y_ref).abs().max())
            if not err <= 2e-5 * ref:
                raise AssertionError(f"{name}: max err {err} > 2e-5 x {ref}")
        span = chip_smoke.device_span_ms(torch, call)
        spans[name].append(span)
        print(f"{name}: span {span:.4f} ms; kernels "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in
                          kernel_times(torch, call).items()), flush=True)
    ssd_scan._lib = plain_lib
    for name in names:
        print(f"{name}: ptxas {built[name][1]}", flush=True)
    print(json.dumps({"device": smi, "shape": MAIN, "span_ms": {
        name: statistics.median(v) for name, v in spans.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
