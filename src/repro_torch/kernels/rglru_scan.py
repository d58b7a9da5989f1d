"""RG-LRU first-order linear recurrence: h_t = a_t ⊙ h_{t−1} + x_t.

Replaces the TPU kernel `repro/kernels/rglru_scan.py:rglru_scan_pallas`
(body `_rglru_kernel`) with the hand-written CUDA kernel in
`csrc/rglru_scan.cu`. a, x: [B, S, D]; h0: [B, D] (zeros when None) →
(hs [B, S, D], h_last [B, D]). The gate algebra (exp(−c·softplus(Λ)·σ(r)),
the √(1−a²) input scaling) is the caller's elementwise work.

The Pallas grid (B, D/blk_d, S/chunk) with its VMEM state row is not
carried over: one CUDA thread owns one (b, d) channel, holds h in a
register and walks t = 0..S−1, so each step's loads and stores are
coalesced over d, and any S and D work without chunking or padding. Each
step is `__fadd_rn(__fmul_rn(a, h), x)` — no FMA contraction — which is
how the plain version rounds (a multiply, then an add), so the kernel
equals it bitwise on the card.

Bound on the H100 at the main path's shape (full recurrentgemma-2b:
B = 40, S = 64, D = 2560, h0 zero): bytes — a, x and hs are 26.2 MB each
plus h_last, about 79 MB, at least 23.6 µs at 3.35 TB/s. The 2 FLOP per
element are negligible.

`linear_recurrence_plain` is the plain PyTorch version (a sequential f32
loop over t, as `repro.kernels.ref.linear_recurrence_ref`); `launches`
counts kernel launches. No single PyTorch call computes this recurrence.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0
#: the f32 operations (a multiply and an add an element) and bytes (a, x and
#: h0 read, hs and h_last written) of those launches, as chip_smoke.py's
#: bound column reckons them
flops = 0.0
moved_bytes = 0.0


def linear_recurrence_plain(a: torch.Tensor, x: torch.Tensor,
                            h0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x: [B, S, D]; h0: [B, D] → (hs [B, S, D], h_last [B, D])."""
    b, s, d = x.shape
    a32, x32 = a.to(torch.float32), x.to(torch.float32)
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    hs = torch.empty((b, s, d), dtype=torch.float32, device=x.device)
    for t in range(s):
        h = a32[:, t] * h + x32[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h.to(x.dtype)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("rglru_scan").rglru_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_cuda(a: torch.Tensor, x: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on f32 CUDA tensors (made contiguous here).
    Returns (hs [B, S, D], h_last [B, D])."""
    global launches, flops, moved_bytes
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"linear_recurrence: a {tuple(a.shape)} and x "
                         f"{tuple(x.shape)} must be one [B, S, D] shape")
    b, s, d = x.shape
    if h0 is not None and tuple(h0.shape) != (b, d):
        raise ValueError(f"linear_recurrence: h0 has shape "
                         f"{tuple(h0.shape)}, want {(b, d)}")
    for name, t in (("a", a), ("x", x), ("h0", h0)):
        if t is not None and (t.device != x.device
                              or t.dtype != torch.float32):
            raise ValueError(f"linear_recurrence: {name} must be f32 on "
                             f"{x.device}")
    a, x = a.contiguous(), x.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    hs = torch.empty_like(x)
    h_last = torch.empty((b, d), dtype=torch.float32, device=x.device)
    from repro_torch.kernels import build
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib()(a.data_ptr(), x.data_ptr(),
                    None if h0 is None else h0.data_ptr(), hs.data_ptr(),
                    h_last.data_ptr(), b, s, d, stream)
    build.check(status, "rglru_scan_f32")
    launches += 1
    flops += 2.0 * b * s * d
    moved_bytes += 4.0 * (3 * b * s * d + b * d * (1 + (h0 is not None)))
    return hs, h_last
