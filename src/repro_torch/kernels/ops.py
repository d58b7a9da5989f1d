"""Kernel entry points: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel (which launches or raises —
there is no fallback); a CPU tensor goes to the plain PyTorch version;
any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import seeded_axpy as sa


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device} (want cuda or cpu)")


def seeded_axpy(w: torch.Tensor, seed: int, scale: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = w + scale · z(seed); `out=w` updates in place. `scale` is a
    0-d f32 tensor on w's device."""
    if _on_cuda(w):
        return sa.seeded_axpy_cuda(w, seed, scale,
                                   torch.empty_like(w) if out is None else out)
    res = sa.seeded_axpy_plain(w, seed, scale)
    return res if out is None else out.copy_(res)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Skv,D] → [B,Hq,Sq,D]."""
    if _on_cuda(q):
        return fa.flash_attention_cuda(q, k, v, causal, window, scale)
    return fa.attention_plain(q, k, v, causal, window, scale)
