#!/usr/bin/env python3
"""perturbed_matmul_bf16's tile and cluster on one GPU, measured by building
the kernel at each choice and by taking pieces away.

    python3 chip_pmm_variants.py [variant ...]

Each variant is src/repro_torch/kernels/csrc/perturbed_matmul.cu with one
or two text substitutions (VARIANTS below), built with nvcc into
build/pmm_variants/ and called through the port's own wrapper at the
bf16-fused path's shapes: one full OPT-125M layer's 7 projections at
M = 2560 rows (5 clients × 8 rows × 64 tokens; (K, N) = (768, 768) × 4,
(768, 3072) × 2, (3072, 768)). The design variants set the output rows a
block (BM = kTcBM), its columns (BN = kTcBN: 64 as built, or 128 at one
block an SM), the rows a warp (kTcWM: 32, or 64 with 64 accumulators a
thread), the depth a step (kTcBK: 32, or 64 at one block an SM) and the
blocks a cluster (C = kTcCluster: 4, or 8); a weight is
drawn once per cluster of BM·C rows, so M / (BM·C) rounded up times (5 as
built, 3 at C = 8, 2 at BM 160 and C = 8), on a grid whose rows are
rounded up to whole clusters. Each is held first, as chip_smoke.py holds
the kernel: within one bf16 ulp of the f32 result at the layer's shapes
and at ragged ones (every x-copy path: K % 8 == 0, K % 8 == 4, ragged K),
two calls bitwise, and the identity probes bitwise against
seeded_axpy_bf16 (one on w + eps·z near 2^-112, whose lo pieces are
subnormal). The `skip_*` variants compute a wrong result by construction
and are only timed: what they save is that part's share. `skip_draws`
stores v = w (no hash), `skip_mma` issues no mma (the ldmatrix reads
stay), `skip_peers` stores each block's drawn pieces into its own shared
memory alone, `skip_all_but_ldmatrix` keeps the cluster barriers and
the ldmatrix reads and drops the hash, the mma, the pieces' stores and
the x copies (w is still loaded), and `skip_all_and_barriers` drops the
steps' cluster barriers too (safe there: no block stores into another).
Every variant runs twice, in the order given and then reversed, on the
same inputs. Printed per run: the device time of
one layer's 7 calls (the kernels' self time under torch.profiler, mean of
5 layers) and of one call at each shape; per variant, ptxas's registers
and spill bytes, and from the built library its registers, local and
shared memory, blocks an SM, resident clusters and grid; then cuBLAS bf16
on the resolved weights (another function: w + eps·z rounded to bf16) by
device time, and one JSON line. Needs one CUDA device and nvcc; exits
non-zero without either.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "perturbed_matmul.cu"
OUT = ROOT / "build" / "pmm_variants"

_BM = "constexpr int kTcBM = 128;"
_BN = "constexpr int kTcBN = 64;"
_WM = "constexpr int kTcWM = 32;"
_C = "constexpr int kTcCluster = 4;"
_BK = "constexpr int kTcBK = 32;"
_BLOCKS = "constexpr int kTcMinBlocks = 2;"
_DRAW = "v[h] = counter_hash::axpy(wf, eps, ctr, seed_mix);"
_MMA = "bf16_mma3(acc[np * 2 + j], a, lo, mid, hi);"
_PEERS = "for (int p = 0; p < kTcCluster; ++p) {"
_OWN = ("for (int p = static_cast<int>(rank); p <= static_cast<int>(rank); "
        "++p) {")
_STORE = ("for (int q = 0; q < 3; ++q) st_cluster_vec(map_rank(local + q * "
          "kTcPiece, p), piece[q]);")
_X = "        fetch_x(s + 2);"
_LOOP_BARRIER = ("    cluster_wait();\n    if (drawer) cp_async_wait<0>();"
                 "               // x tile s + 1 has landed\n"
                 "    cluster_arrive();\n")
_NO_LOOP_BARRIER = "    if (drawer) cp_async_wait<0>();\n"


def _set(anchor: str, value) -> tuple:
    """The substitution that sets the constant at `anchor` to `value`."""
    return (anchor, re.sub(r"= \d+;", f"= {value};", anchor))


VARIANTS = {
    "as_built": [],
    "bn128": [_set(_BN, 128), _set(_BLOCKS, 1)],
    "bn128_wm64": [_set(_BN, 128), _set(_WM, 64), _set(_BLOCKS, 1)],
    "bk64": [_set(_BK, 64)],
    "c8": [_set(_C, 8)],
    "bm160_c8": [_set(_BM, 160), _set(_C, 8)],
    "skip_draws": [(_DRAW, "v[h] = wf;")],
    "skip_mma": [(_MMA, "")],
    "skip_peers": [(_PEERS, _OWN)],
    "skip_draws_mma": [(_DRAW, "v[h] = wf;"), (_MMA, "")],
    "skip_all_but_ldmatrix": [(_DRAW, "v[h] = wf;"), (_MMA, ""),
                              (_STORE, ""), (_X, "")],
    "skip_all_and_barriers": [(_DRAW, "v[h] = wf;"), (_MMA, ""), (_STORE, ""),
                       (_X, ""), (_LOOP_BARRIER, _NO_LOOP_BARRIER)],
}
# (M, K, N, counter offset): the layer's shapes, then ragged ones
CHECKS = ((2560, 768, 768, 3 * 768 * 768), (2560, 768, 3072, 0),
          (2560, 3072, 768, 5 * 3072 * 768), (37, 200, 300, 2**32 - 7777),
          (2597, 768, 768, 0), (130, 203, 130, 0), (300, 772, 640, 123457))


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} found {src.count(old)} "
                                 "times in the source")
        src = src.replace(old, new)
    return src


def ptxas_summary(log: str) -> dict:
    """pmm_kernel_bf16's registers and spill bytes, from ptxas -v."""
    out, inside = {}, False
    for line in log.splitlines():
        if "Function properties for" in line:
            inside = "pmm_kernel_bf16" in line
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and inside:
            out.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and inside:
            out["registers"] = int(m.group(1))
    return out


def build(names) -> dict:
    """One nvcc per variant, all started together (the port's flags plus
    -Xptxas -v); returns name -> (library path, ptxas summary)."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    headers = {p.name: p.read_text() for p in kbuild.CSRC.glob("*.cuh")}
    for name, text in headers.items():
        (OUT / name).write_text(text)
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
        out[name] = (lib, ptxas_summary(log))
    return out


def attributes(lib, m: int, n: int) -> dict:
    from repro_torch.kernels import build as kbuild
    fn = lib.perturbed_matmul_attributes
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "cluster", "resident_clusters", "blocks_per_sm", "grid_blocks",
            "block_rows", "block_cols", "block_k", "threads")
    info = (ctypes.c_int * len(keys))()
    kbuild.check(fn(m, n, 1, ctypes.addressof(info)), "attributes")
    return dict(zip(keys, info))


def check(torch, dev, gen, cs) -> float:
    """The variant (installed as the wrapper's library) against the f32
    result and seeded_axpy_bf16; returns its largest error in bf16 ulp."""
    from repro_torch.kernels import perturbed_matmul as pmm
    from repro_torch.kernels import seeded_axpy as sa
    bf16 = torch.bfloat16
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    worst = 0.0
    for m, k, n, off in CHECKS:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(bf16)
        seed = sa.seed_tensor(55, dev)
        got = pmm.perturbed_matmul_cuda(x, w, seed, off, eps)
        ref = pmm.perturbed_matmul_plain(x.float(), w.float(), 55, off, eps)
        worst = max(worst, cs.within_bf16_ulp(
            torch, got, ref, f"[{m},{k}]x[{k},{n}]"))
        cs.require_equal(torch, pmm.perturbed_matmul_cuda(x, w, seed, off,
                                                          eps), got,
                         f"[{m},{k}]x[{k},{n}] two calls")
    tiny = torch.tensor(2.0 ** -113, dtype=torch.float32, device=dev)
    for k, n, off, scale, e in ((768, 768, 5 * 768 * 768, 1.0, eps),
                                (3072, 768, 0, 1.0, eps),
                                (768, 768, 99, 2.0 ** -112, tiny)):
        w = (torch.randn((k, n), generator=gen, device=dev) * scale).to(bf16)
        seed = sa.seed_tensor(66, dev)
        probe = pmm.perturbed_matmul_cuda(
            torch.eye(k, device=dev, dtype=bf16), w, seed, off, e)
        cs.require_equal(torch, probe, sa.seeded_axpy_cuda(
            w, seed, e, torch.empty_like(w), off),
            f"identity probe [{k},{n}] at scale {scale}")
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_pmm_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import perturbed_matmul as pmm
    from repro_torch.kernels import seeded_axpy as sa

    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = build(names)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(31)
    m_rows = cs.M_ROWS
    x = {k: torch.randn((m_rows, k), generator=gen, device=dev).to(bf16)
         for k in (768, 3072)}
    ws = [(torch.randn(s, generator=gen, device=dev) / math.sqrt(s[0])
           ).to(bf16) for s in cs.PMM_LAYER]
    s7 = sa.seed_tensor(7, dev)
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    plain_lib = pmm._lib
    libs = {name: ctypes.CDLL(str(built[name][0])) for name in names}
    times = {name: [] for name in names}
    info = {}
    for name in names + names[::-1]:
        fn = libs[name].perturbed_matmul_bf16
        fn.argtypes = list(pmm._ARGS)
        fn.restype = ctypes.c_int
        pmm._lib = lambda fn=fn: {bf16: fn}
        if name not in info:
            info[name] = {"ptxas": built[name][1],
                          "attributes": attributes(libs[name], m_rows, 768)}
            if "skip" not in name:
                info[name]["max_bf16_ulp"] = check(torch, dev, gen, cs)
        layer = lambda: [pmm.perturbed_matmul_cuda(  # noqa: E731
            x[w.shape[0]], w, s7, 0, eps) for w in ws]
        ms = cs.device_ms(torch, layer, reps=5)
        times[name].append(ms)
        shapes = {f"{k}x{n}": cs.device_ms(torch, lambda k=k, n=n: (
            pmm.perturbed_matmul_cuda(x[k], next(w for w in ws
                                                 if w.shape == (k, n)),
                                      s7, 0, eps)), reps=10)
            for k, n in cs.PMM_SHAPES}
        info[name].setdefault("per_call_ms", []).append(shapes)
        print(f"{name}: one layer's 7 at M={m_rows}: device time {ms:.4f} "
              f"ms; per call {shapes}", flush=True)
    pmm._lib = plain_lib
    resolved = [sa.seeded_axpy_cuda(w, s7, eps, torch.empty_like(w), 0)
                for w in ws]
    lib_ms = cs.device_ms(torch, lambda: [torch.matmul(x[w.shape[0]], r)
                                          for w, r in zip(ws, resolved)],
                          reps=5)
    flops = sum(2.0 * m_rows * k * n for k, n in cs.PMM_LAYER)
    bound = 3 * flops / cs.BF16_FLOPS_PER_S * 1e3
    rows = {}
    for name in names:
        a = info[name]["attributes"]
        ms = statistics.median(times[name])
        rows[name] = dict(
            device_ms=times[name], median_ms=ms, bound_share=bound / ms,
            draws_per_weight=math.ceil(m_rows / (a["block_rows"]
                                                 * a["cluster"])),
            live_row_blocks=math.ceil(m_rows / a["block_rows"]),
            **info[name])
        print(f"{name}: median {ms:.4f} ms ({bound / ms:.3f} of the 3xbf16 "
              f"bound {bound:.4f}); draws a weight "
              f"{rows[name]['draws_per_weight']}; {info[name]}", flush=True)
    print(f"cuBLAS bf16 on resolved w (another function): device time "
          f"{lib_ms:.4f} ms", flush=True)
    print(json.dumps({"device": smi, "rows": m_rows, "bound_ms": bound,
                      "library_ms": lib_ms, "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
