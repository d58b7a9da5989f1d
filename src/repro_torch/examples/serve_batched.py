"""Serve a (fine-tuned) model with batched requests, ported from the
reference's `examples/serve_batched.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch yi-6b --gen 24 --device cpu

Uses the reduced config, as the reference does. Requests of different
prompt lengths are left-padded into one batch (continuous batching is a
scheduler concern; the step itself is batch-first).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import prng, resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.serve import serve_loop
from repro_torch.models import registry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-370m", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    params = registry.init_params(cfg, prng.key(0), dev)
    rng = np.random.default_rng(0)

    # a "request queue": variable-length prompts left-padded to one batch
    lens = rng.integers(args.prompt_len // 2, args.prompt_len + 1,
                        size=args.batch)
    batch = np.zeros((args.batch, args.prompt_len), np.int32)
    for i, ln in enumerate(lens):
        batch[i, -ln:] = rng.integers(8, cfg.vocab_size, size=ln)

    print(f"serving {args.arch} (reduced): batch={args.batch} "
          f"prompts of lens {lens.tolist()}")
    t0 = time.time()
    out = serve_loop(cfg, params, batch, args.gen)
    dt = time.time() - t0
    print(f"generated {args.gen} tokens/req in {dt:.2f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s on {dev.type})")
    for i in range(min(args.batch, 2)):
        print(f"  req{i}: ...{out[i, -args.gen:].tolist()}")
    return out


if __name__ == "__main__":
    main()
