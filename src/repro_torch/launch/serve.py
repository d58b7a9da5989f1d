"""Serving launcher: batched greedy decode on the GPU, ported from
`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch yi-6b --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch mamba2-370m

Runs prefill once, then a decode loop with the architecture's own state:
the KV cache of the dense and moe families (MLA's compressed latent
cache where the config has MLA), the SSD state and conv tail of the ssm
family, the recurrent state and rolling attention window of the hybrid
family. Every state is updated in place. The decode step runs eagerly
(the reference jits it with the cache donated): one launch per operation.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import registry


def serve_loop(cfg, params, tokens, gen_steps: int, *, extra_cap: int = 0,
               impl=None, hook: Optional[Callable[[str], None]] = None):
    """Prefill + greedy decode on the params' device. tokens: [B, S_prompt]
    int → [B, S_prompt + gen_steps] int32 numpy: the prompt, the prefill's
    argmax, then gen_steps − 1 decode steps' argmax. `extra_cap` is taken
    and unused, as in the reference. `hook(stage)`, if given, is called
    with "start" (the prompt on the device), "prefill" and "decode" (after
    each step) as the work is enqueued: a caller can record CUDA events
    there."""
    if impl is not None:
        raise NotImplementedError(
            "impl= (picking the plain versions or a kernel by name) is not "
            "ported (ROADMAP A12)")
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"serving the {cfg.family} family is not ported (ROADMAP A8: "
            f"{cfg.family})")
    mod = registry.get_module(cfg)
    embed = params["embed"]["w"]
    dev, dtype = embed.device, embed.dtype
    b, s = tokens.shape
    mark = hook or (lambda stage: None)
    prompt = torch.as_tensor(np.asarray(tokens), device=dev).long()
    mark("start")

    logits, cache = mod.prefill(params, cfg, prompt)
    if cfg.family in ("dense", "moe"):
        # prefill's cache (k/v, or MLA's latent) holds the prompt; decode
        # writes past it, into one buffer of the whole length, filled once
        # along the sequence dim (dim 2 of every leaf)
        small = cache
        cache = mod.init_cache(cfg, b, s + gen_steps, dtype=dtype,
                               device=dev)
        for name, c in small.items():
            cache[name][:, :, :s] = c
        del small
    tok = torch.argmax(logits[:, -1:], dim=-1)              # [B, 1]
    mark("prefill")
    out = [tok]
    for i in range(gen_steps - 1):
        logits, cache = mod.decode_step(params, cfg, cache, tok, s + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
        mark("decode")
    gen = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    return np.concatenate([np.asarray(tokens, dtype=np.int32), gen], axis=1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-370m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv=None):
    """The reference's CLI plus --device: the same prompts and, from the
    same --seed, the same weights; prints its two lines and returns the
    output tokens."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = registry.init_params(cfg, prng.key(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(8, cfg.vocab_size,
                          size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = serve_loop(cfg, params, tokens, args.gen)
    dt = time.time() - t0
    print(f"arch={cfg.name} generated {args.gen} tokens x batch "
          f"{args.batch} in {dt:.2f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s)")
    print("sample row:", out[0, -args.gen:])
    return out


if __name__ == "__main__":
    main()
