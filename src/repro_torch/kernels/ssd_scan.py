"""Mamba-2 chunked SSD scan (state-space duality, ngroups = 1).

Replaces the TPU kernel `repro/kernels/ssd_scan.py:ssd_scan_pallas` (body
`_ssd_kernel`) with the hand-written CUDA kernel in `csrc/ssd_scan.cu`.
Per (batch, head), sequentially over chunks of Q rows:

    g       = cumsum(a·dt)                              chunk-local decay
    y       = ((C Bᵀ) ⊙ L)(x·dt) + exp(g) ⊙ (C S_prev)   L = exp(gᵢ − gⱼ)·[i ≥ j]
    S_new   = exp(g_last)·S_prev + Σᵢ exp(g_last − gᵢ) Bᵢ (x·dt)ᵢᵀ

Layouts are `repro.kernels.ops.ssd`'s: x [B,S,H,P], dt [B,S,H], a [H],
b/c [B,S,N], state [B,H,P,N].

Bound on the H100 at the main path's shape (full mamba2-370m: B = 40,
S = 64, H = 32, P = 64, N = 128, chunk 64): f32 operations, about 3.7
MFLOP per (b, h, chunk) × 1280 = 4.7 GFLOP counting the full Q × Q
products (3.7 GFLOP counting only their causal half), 0.055–0.070 ms at
67 TFLOP/s; the bytes are about 87 MB with the 42 MB final state (0.026
ms). The kernel keeps the [N, P] state in shared memory across chunks and
streams B and C in 64-row blocks, so chunks of 256 rows fit too.

`ssd_plain` is the plain PyTorch version (`repro`'s `_xla_chunked_ssd`);
`launches` counts kernel launches. No single PyTorch call computes this
function.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

MAX_HEAD_DIM = 64
MAX_D_STATE = 128

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


@functools.cache
def _serial_first_exp() -> None:
    """One exp below the intra-op grain, so on the calling thread. torch's
    CPU exp runs MKL's vector math over OpenMP threads, and when the first
    such call of a process is parallel, the library's first-use set-up
    races between the threads and one chunk may come out wrong (1 in 32
    fresh processes for a first ssd_plain at [2, 96, 3, 16]; ROADMAP C).
    After a serial first call it never did. The result bits are torch's
    own either way."""
    torch.exp(torch.zeros(1))


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor,
              state0: Optional[torch.Tensor], chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch: a loop over chunks, dense products
    within. Returns (y [B,S,H,P], state [B,H,P,N] f32)."""
    if x.device.type == "cpu":
        _serial_first_exp()
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd: seq {s} is not a multiple of chunk {chunk}")
    n_c = s // chunk
    f32 = torch.float32
    xf = x.to(f32).reshape(bsz, n_c, chunk, h, p)
    dtf = dt.to(f32).reshape(bsz, n_c, chunk, h)
    bf = b.to(f32).reshape(bsz, n_c, chunk, n)
    cf = c.to(f32).reshape(bsz, n_c, chunk, n)
    af = a.to(f32)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if state0 is None else state0.to(f32))
    ys = []
    for ci in range(n_c):
        x_c, dt_c, b_c, c_c = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        g = torch.cumsum(af[None, None] * dt_c, dim=1)             # [B,Q,H]
        xdt = x_c * dt_c[..., None]
        cb = torch.einsum("bqn,bkn->bqk", c_c, b_c)                # [B,Q,Q]
        decay = torch.exp(g[:, :, None] - g[:, None])              # [B,Q,Q,H]
        l_mask = torch.where(causal[None, :, :, None], decay,
                             torch.zeros((), dtype=f32, device=x.device))
        y_intra = torch.einsum("bqk,bqkh,bkhp->bqhp", cb, l_mask, xdt)
        y_inter = torch.exp(g)[..., None] * torch.einsum(
            "bhpn,bqn->bqhp", state, c_c)
        g_last = g[:, -1]                                          # [B,H]
        w = torch.exp(g_last[:, None] - g)[..., None] * b_c[:, :, None]
        state = torch.exp(g_last)[..., None, None] * state + torch.einsum(
            "bqhn,bqhp->bhpn", w, xdt)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p).to(x.dtype)
    return y, state


def _lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan").ssd_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  state0: Optional[torch.Tensor], chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on f32 CUDA tensors (made contiguous here).
    Returns (y [B,S,H,P], state [B,H,P,N])."""
    global launches
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    want = {"dt": (bsz, s, h), "a": (h,), "b": (bsz, s, n),
            "c": (bsz, s, n), "state0": (bsz, h, p, n)}
    args = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "state0": state0}
    for name, t in args.items():
        if t is None:
            continue
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"ssd: {name} has shape {tuple(t.shape)}, "
                             f"want {want[name]}")
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"ssd: {name} must be f32 on {x.device}")
    if p > MAX_HEAD_DIM or n > MAX_D_STATE:
        raise ValueError(f"ssd: head_dim {p} > {MAX_HEAD_DIM} or d_state "
                         f"{n} > {MAX_D_STATE} is not supported by the "
                         "CUDA kernel")
    if s % chunk:
        raise ValueError(f"ssd: seq {s} is not a multiple of chunk {chunk}")
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    s0 = None if state0 is None else state0.contiguous()
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    from repro_torch.kernels import build
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), None if s0 is None else s0.data_ptr(),
                    y.data_ptr(), state.data_ptr(), bsz, s, h, p, n, chunk,
                    stream)
    build.check(status, "ssd_scan_f32")
    launches += 1
    return y, state
