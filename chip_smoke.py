#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one GPU and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. the card's name and power limit; build every CUDA kernel from
     src/repro_torch/kernels/csrc (one nvcc per source, in parallel);
  2. each kernel against its plain version on the card at the main path's
     shapes, with stated tolerances, then timed (CUDA events, warm-up,
     median) beside the plain version, a PyTorch library call where one
     computes the same function, and the card's bound for the same work;
  3. a small-input reference check: the same tiny-model run on the GPU
     (kernels) and on the CPU (plain versions) agrees;
  4. the main path: `repro_torch.core.fedsim.run` at full OPT-125M width
     with the training CLI's defaults (5 clients, batch 8, seq 64,
     n_perturb 4, analog/solution/Rayleigh, chained, loop engine) for 3
     rounds, with the launch counters set to 0 just before and read just
     after;
  5. one `kernels` JSON line, then the result line.

Needs one CUDA device and the repository checkout (it imports the port
from src/); exits non-zero without either. `--profile` adds one more
main-path round under torch.profiler and prints where its device time
goes (top kernels by device time, and the device's busy share).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
ROUNDS = 3


def time_ms(torch, fn, warmup: int = 3, reps: int = 15) -> float:
    """Median CUDA-event time of one call of fn, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float) -> tuple:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def ulps(torch, a, b) -> int:
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max())


def check_seeded_axpy(torch, dev) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.core import zo
    from repro_torch.kernels import seeded_axpy as sa
    from repro_torch.models import registry, transformer

    cfg = get_arch("opt-125m")
    shapes = list(transformer.shapes(cfg)) + [(1_000_003,)]   # + ragged
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = torch.tensor(-3e-3, dtype=torch.float32, device=dev)
    max_err = 0.0
    for i, shape in enumerate(shapes):
        w = torch.randn(shape, generator=gen, device=dev)
        seed = zo.leaf_seed(0xC0FFEE, i)
        got = sa.seeded_axpy_cuda(w, seed, scale, torch.empty_like(w))
        want = sa.seeded_axpy_plain(w, seed, scale)
        err = float((got - want).abs().max())
        # |Δz| ≤ 4 ulp of |z| (< 6) times |scale|, plus one ulp of the sum
        tol = 3e-3 * 4 * 6 * 2.0 ** -23 + float(want.abs().max()) * 2.0 ** -23
        if not err <= tol:
            raise AssertionError(f"seeded_axpy {shape}: max err {err} > {tol}")
        max_err = max(max_err, err)
        # in place (out aliases w) gives the same bits as out of place
        sa.seeded_axpy_cuda(w, seed, scale, w)
        if not torch.equal(w, got):
            raise AssertionError(f"seeded_axpy {shape}: in-place differs")
        del w, got, want
    # z probe: w = 0, scale = 1 returns z itself; every bit of z follows
    # from the hash bits, so a wrong hash bit would show as a gross error
    n = 4_000_037
    one = torch.ones((), dtype=torch.float32, device=dev)
    zeros = torch.zeros(n, device=dev)
    z_k = sa.seeded_axpy_cuda(zeros, 77, one, torch.empty_like(zeros))
    z_p = sa.draw_z((n,), 77, dev)
    z_ulps = ulps(torch, z_k, z_p)
    z_same = float((z_k == z_p).float().mean())
    if z_ulps > 2:
        raise AssertionError(f"seeded_axpy z probe: {z_ulps} ulp from plain")
    # scale 0 probe: the axpy adds exactly nothing
    w = torch.randn(n, generator=gen, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if not torch.equal(sa.seeded_axpy_cuda(w, 5, zero, torch.empty_like(w)),
                       w):
        raise AssertionError("seeded_axpy scale-0 probe changed w")
    print(f"seeded_axpy: {len(shapes)} shapes ok, max err {max_err:.3e}; "
          f"z probe {z_ulps} ulp max, {z_same:.6f} bit-identical", flush=True)

    # one θ pass over full OPT-125M (12 launches), as `zo.perturb` runs it
    params = registry.init_params(cfg, gen, dev)
    leaves = [t for _, t in zo.flatten(params)]
    n_total = sum(t.numel() for t in leaves)
    ms = time_ms(torch, lambda: zo.perturb(params, 1234, scale, inplace=True))
    plain_ms = time_ms(torch, lambda: [sa.seeded_axpy_plain(t, 9, scale)
                                       for t in leaves], warmup=1, reps=3)
    # f32 work per element: 2 unit conversions + 2 floors, log, ×(−2),
    # sqrt, ×2π, cos, ×r, ×scale, +w (the integer hash is not counted)
    b_ms, b_by = bound_ms(8.0 * n_total, 12.0 * n_total)
    del params, leaves
    torch.cuda.empty_cache()
    return {"name": "seeded_axpy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/seeded_axpy.cu",
            "replaces": "src/repro/kernels/seeded_axpy.py:83",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"one θ pass, {n_total} f32 elements in 12 leaves"}


def check_flash_attention(torch, dev) -> dict:
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # (q shape, kv shape, causal, window)
        ((40, 12, 64, 64), (40, 12, 64, 64), True, None),   # main path
        ((2, 8, 48, 64), (2, 2, 80, 64), True, 32),          # GQA, Sq<Skv
        ((3, 4, 33, 16), (3, 4, 33, 16), False, None),       # tiny-model D
    ]
    max_err = 0.0
    for qs, ks, causal, window in cases:
        q = torch.randn(qs, generator=gen, device=dev)
        k = torch.randn(ks, generator=gen, device=dev)
        v = torch.randn(ks, generator=gen, device=dev)
        got = fa.flash_attention_cuda(q, k, v, causal, window)
        want = fa.attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"flash_attention {qs}/{ks}: max err {err}")
        max_err = max(max_err, err)
    print(f"flash_attention: {len(cases)} cases ok, max err {max_err:.3e}",
          flush=True)

    b, h, s, d = cases[0][0]
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               for _ in range(3))
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, True))
    plain_ms = time_ms(torch, lambda: fa.attention_plain(q, k, v, True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
    visible = s * (s + 1) // 2                 # causal pairs per head
    # per visible pair: q·k (2d), p·v (2d), exp and the sum (≈3)
    flops = b * h * visible * (4 * d + 3)
    b_ms, b_by = bound_ms(4.0 * 4 * b * h * s * d, flops)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:104",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": f"[{b},{h},{s},{d}] causal"}


def pz_defaults(cfg, rounds: int, n_perturb: int = 4):
    """The training CLI's defaults (`python -m repro.launch.train`)."""
    from repro_torch.configs.base import (ChannelConfig, DPConfig,
                                          PairZeroConfig, PowerControlConfig,
                                          TransportConfig, ZOConfig)
    return PairZeroConfig(
        variant="analog", n_clients=5, rounds=rounds,
        zo=ZOConfig(mu=1e-3, lr=5e-3, clip_gamma=5.0, n_perturb=n_perturb),
        channel=ChannelConfig(n0=1.0, power=100.0, d=cfg.param_count(),
                              model="rayleigh"),
        dp=DPConfig(epsilon=5.0, delta=0.01),
        power=PowerControlConfig(scheme="solution"),
        transport=TransportConfig(mechanism="analog", scheme="solution"),
        seed=0)


def check_small_reference(torch, dev) -> None:
    """Tiny model, 2 rounds: the GPU run (kernels) and the CPU run (plain
    versions) from the same weights agree (losses rtol 1e-4)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import fedsim
    from repro_torch.data.pipeline import FederatedPipeline
    from repro_torch.data.tasks import TaskSpec
    from repro_torch.models import registry

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                      head_dim=16)
    pz = pz_defaults(cfg, rounds=8, n_perturb=2)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0)
    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    def weights(device):
        gen = torch.Generator().manual_seed(3)
        return to(registry.init_params(cfg, gen, "cpu"), device)

    gpu = fedsim.run(cfg, pz, pipe, 2, params=weights(dev), device=dev)
    cpu = fedsim.run(cfg, pz, pipe, 2, params=weights("cpu"), device="cpu")
    for a, b in zip(gpu.losses, cpu.losses):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"tiny run: GPU loss {a} vs CPU loss {b}")
    print(f"small-input reference: GPU losses {gpu.losses} match CPU "
          f"{cpu.losses} (rtol 1e-4)", flush=True)


def profile_round(torch, fedsim, cfg, pz, pipe, params, dev) -> None:
    """One more main-path round under torch.profiler: the kernels that take
    the device time, and the share of the round's wall time the device was
    busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fedsim.run(cfg, pz, pipe, 1, params=params, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel-level rows only: the aten ops above them carry the same time
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: one round, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / wall_us:.3f} of wall)", flush=True)
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3:9.3f} ms {dev_us / busy:6.3f} x{count:<5d} "
              f"{key[:90]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core import fedsim
    from repro_torch.data.pipeline import FederatedPipeline
    from repro_torch.data.tasks import TaskSpec
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import seeded_axpy as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(f"kernel build: {build.build():.1f} s", flush=True)

    rows = [check_seeded_axpy(torch, dev), check_flash_attention(torch, dev)]
    check_small_reference(torch, dev)

    # -- the main path: full OPT-125M, CLI defaults -------------------------
    cfg = get_arch("opt-125m")
    pz = pz_defaults(cfg, rounds=800)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", cfg.vocab_size, 64),
                             n_clients=5, per_client_batch=8, seed=0)
    theta_bytes = 4 * cfg.param_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    sa.launches = 0
    fa.launches = 0
    t0 = time.perf_counter()
    res = fedsim.run(cfg, pz, pipe, ROUNDS, device=dev,
                     on_round=lambda t, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"seeded_axpy": sa.launches, "flash_attention": fa.launches}
    peak = torch.cuda.max_memory_allocated()

    if len(res.losses) != ROUNDS or not all(map(math.isfinite, res.losses)):
        raise AssertionError(f"main path losses {res.losses}")
    if not all(map(math.isfinite, res.p_hats)):
        raise AssertionError(f"main path p_hats {res.p_hats}")
    if not res.privacy_spent > 0:
        raise AssertionError(f"privacy spent {res.privacy_spent}")
    from repro_torch.core import zo
    leaves = len(zo.flatten(res.params))
    expected = {"seeded_axpy": ROUNDS * 4 * 3 * leaves,
                "flash_attention": ROUNDS * 4 * 2 * cfg.n_layers}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    steady = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
    print(f"main path: opt-125m, {ROUNDS} rounds; run {wall:.3f} s with "
          f"weight init and schedule solve; steady {steady * 1e3:.1f} "
          f"ms/round, {1 / steady:.3f} rounds/s; "
          f"losses {res.losses}; p_hat {res.p_hats}; privacy spent "
          f"{res.privacy_spent:.6g} of {res.privacy_budget:.6g}", flush=True)
    print(f"peak device memory {peak / 1e6:.1f} MB = {peak / theta_bytes:.2f}"
          f" x theta ({theta_bytes / 1e6:.1f} MB f32)", flush=True)
    print(f"launches on the main path: {launches}", flush=True)

    if "--profile" in sys.argv[1:]:
        profile_round(torch, fedsim, cfg, pz, pipe, res.params, dev)

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
