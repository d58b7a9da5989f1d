#!/usr/bin/env python3
"""Run chip_smoke.py's phase-4 paths alone on one GPU, and with
`--profile` show where the scenario paths' time goes.

    python3 chip_scenarios.py [--profile] [attacked] [fo-desync] [observed]

Builds the kernels, then runs the named paths (default: attacked and
fo-desync) exactly as chip_smoke.py's phase 4 does (`run_attacked_path`,
`run_fo_desync_path`, `run_observed_path`: the same runs, gates and
prints). `--profile` then takes, for the scenario paths named, under
torch.profiler on full-width OPT-125M from the seed-0 init: one loop
round of each path (the attacked path's, and fo-desync's with the
captured gradient's copy to the host), and DLG_PROFILED steps of DLG on a
captured gradient after two warm-up steps, printing for each the wall
time, the device's busy time, the top 12 kernels and copies by device
time and the top 12 operations by host time. Exits non-zero without a
CUDA device or on any failed gate.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

DLG_PROFILED = 3


def profiled(torch, what: str, fn) -> None:
    """fn() under torch.profiler: the wall time, the device's busy time,
    the top 12 kernels and copies by device time and the top 12
    operations by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {what}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms ({sum(e.count for e in kernels)} kernels and "
          "copies)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<6d} "
              f"{e.key[:90]}", flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=12),
          flush=True)


def profile_paths(torch, dev, cfg, names) -> None:
    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch import privacy as pv
    from repro_torch.core import fedsim
    from repro_torch.models import registry
    for name in names:
        pz, pipe = cs.scenario_setup(name, cfg)
        params = registry.init_params(cfg, prng.key(pz.seed), dev)
        hook = pv.AttackHook()
        profiled(torch, f"{name}: one loop round", lambda: fedsim.run(
            cfg, pz, pipe, 1, device=dev, params=params,
            adversary=pv.Adversary(), hooks=[hook]))
        if name == "fo-desync":
            g_star = hook.observations()["obs_grad0"][0]
            fresh = registry.init_params(cfg, prng.key(pz.seed), dev)
            batch = pipe.batch(0)
            kw = dict(targets=batch["targets"][0], mask=batch["mask"][0])
            pv.get("dlg")(steps=2).run(cfg, fresh, g_star, **kw)
            profiled(torch, f"fo-desync: {DLG_PROFILED} DLG steps "
                     "(with its set-up and the gradient's copy to the "
                     "card)", lambda: pv.get("dlg")(
                         steps=DLG_PROFILED).run(cfg, fresh, g_star, **kw))
            del fresh
        del params, hook
        cs.release_device_memory(torch)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_scenarios: no CUDA device", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    sys.path.insert(0, str(here / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    names = [a for a in args if not a.startswith("--")] \
        or ["attacked", "fo-desync"]
    runs = {"attacked": cs.run_attacked_path,
            "fo-desync": cs.run_fo_desync_path,
            "observed": cs.run_observed_path}
    dev = torch.device("cuda")
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    print(f"kernel build: {build.build():.1f} s", flush=True)
    opt = get_arch("opt-125m")
    for name in names:
        t0 = time.perf_counter()
        print(runs[name](torch, dev, opt), flush=True)
        cs.release_device_memory(torch)
        print(f"path {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if "--profile" in args:
        profile_paths(torch, dev, opt,
                      [n for n in names if n in ("attacked", "fo-desync")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
