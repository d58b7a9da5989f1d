"""Serving launcher: batched greedy decode on the GPU, ported from
`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch yi-6b --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch mamba2-370m

Runs prefill once, then a decode loop with the architecture's own state:
the KV cache of the dense and moe families (MLA's compressed latent
cache where the config has MLA) and of the vlm behind its zero patch
embeddings, the audio family's self cache and its cross cache over zero
frames, the SSD state and conv tail of the ssm family, the recurrent state
and rolling attention window of the hybrid family. Every state is updated
in place. The decode step runs eagerly
(the reference jits it with the cache donated): one launch per operation.

`serve_loop` takes the reference's `impl=` (`kernels.ops.use_impl`) and
serves params in their own dtype: bf16 params of the dense family's GQA
models give a bf16 KV cache, as the reference's `init_cache(...,
dtype=dtype)`; other families in bf16 raise NotImplementedError naming
ROADMAP A12. The CLI, as the reference's, has no dtype flag.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.core import zo
from repro_torch.kernels import ops as kops
from repro_torch.models import registry


def frontend_zeros(cfg, batch: int, like: torch.Tensor):
    """The vlm's stub patch embeddings for serving, zeros [batch,
    n_frontend_tokens, d_model] on `like`'s device and dtype, as the
    reference serves them; None for the other families (the audio family's
    modules take zero frames where none are given)."""
    if cfg.family != "vlm":
        return None
    return torch.zeros((batch, cfg.frontend.n_frontend_tokens, cfg.d_model),
                       dtype=like.dtype, device=like.device)


def _grown(c: torch.Tensor, n: int) -> torch.Tensor:
    """A cache leaf [L, B, S, ...] copied into zeros of length n along its
    sequence dim, once."""
    big = c.new_zeros(c.shape[:2] + (n,) + c.shape[3:])
    big[:, :, :c.shape[2]] = c
    return big


def start(cfg, params, prompt: torch.Tensor, gen_steps: int):
    """Prefill of `prompt` [B, S] (int64 on the params' device) behind the
    family's zero frontend input, and the decode state sized for
    `gen_steps` more tokens: (last logits [B, 1, V], state, the position of
    the first decode step). The KV caches of the dense, moe and vlm
    families and the audio family's self cache are copied once into a
    buffer of the whole length (the vlm's holds the P patch positions too,
    so its decode starts at S + P); the audio family's cross cache (its
    `cross_` leaves) and the ssm and hybrid states are used as the prefill
    leaves them."""
    mod = registry.get_module(cfg)
    leaf = zo.flatten(params)[0][1]
    b, s = prompt.shape
    front = frontend_zeros(cfg, b, leaf)
    if cfg.family in ("ssm", "hybrid"):
        logits, state = mod.prefill(params, cfg, prompt)
        return logits, state, s
    logits, small = mod.prefill(params, cfg, prompt, prefix_embeds=front)
    grow = [name for name in small if not name.startswith("cross_")]
    s_tot = small[grow[0]].shape[2]
    cache = {name: _grown(c, s_tot + gen_steps) if name in grow else c
             for name, c in small.items()}
    return logits, cache, s_tot


def serve_loop(cfg, params, tokens, gen_steps: int, *, extra_cap: int = 0,
               impl=None, hook: Optional[Callable[[str], None]] = None):
    """Prefill + greedy decode on the params' device. tokens: [B, S_prompt]
    int → [B, S_prompt + gen_steps] int32 numpy: the prompt, the prefill's
    argmax, then gen_steps − 1 decode steps' argmax. `extra_cap` is taken
    and unused, as in the reference. `impl` names the kernels'
    implementation (`kernels.ops.IMPLS`), as in the reference; the params'
    dtype is the cache's (`registry.check_dtype`). `hook(stage)`, if
    given, is called with "start" (the prompt on the device), "prefill"
    and "decode" (after each step) as the work is enqueued: a caller can
    record CUDA events there."""
    registry.check_dtype(cfg, zo.flatten(params)[0][1].dtype)
    with kops.use_impl(impl):
        return _serve(cfg, params, tokens, gen_steps, hook)


def _serve(cfg, params, tokens, gen_steps: int, hook):
    mod = registry.get_module(cfg)
    mark = hook or (lambda stage: None)
    prompt = torch.as_tensor(np.asarray(tokens),
                             device=zo.flatten(params)[0][1].device).long()
    mark("start")
    logits, cache, pos = start(cfg, params, prompt, gen_steps)
    tok = torch.argmax(logits[:, -1:], dim=-1)              # [B, 1]
    mark("prefill")
    out = [tok]
    for i in range(gen_steps - 1):
        logits, cache = mod.decode_step(params, cfg, cache, tok, pos + i)
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
