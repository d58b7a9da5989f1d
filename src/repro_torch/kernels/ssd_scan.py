"""Mamba-2 chunked SSD scan (state-space duality, ngroups = 1).

Replaces the TPU kernel `repro/kernels/ssd_scan.py:ssd_scan_pallas` (body
`_ssd_kernel`) with the hand-written CUDA kernels in `csrc/ssd_scan.cu`.
Per (batch, head), sequentially over chunks of Q rows:

    g       = cumsum(a·dt)                              chunk-local decay
    y       = ((C Bᵀ) ⊙ L)(x·dt) + exp(g) ⊙ (C S_prev)   L = exp(gᵢ − gⱼ)·[i ≥ j]
    S_new   = exp(g_last)·S_prev + Σᵢ exp(g_last − gᵢ) Bᵢ (x·dt)ᵢᵀ

Layouts are `repro.kernels.ops.ssd`'s: x [B,S,H,P], dt [B,S,H], a [H],
b/c [B,S,N], state [B,H,P,N].

Two entries: the stateful one returns the final state (the whole function
of the TPU kernel, for a prefill); `want_state=False` returns (y, None),
and the kernel then skips the last chunk's state update and the state's
write. Training asks for y only. Bound on the H100 at the main path's shape
(full mamba2-370m: B = 40, S = 64, H = 32, P = 64, N = 128, chunk 64, no
state0), counting what each entry needs: y only, 0.36 GFLOP against 44.9
MB (13.4 µs, bytes); with the state, 1.70 GFLOP against 86.8 MB (25.9 µs,
bytes). C·Bᵀ, which all heads share, is computed once per (batch row,
chunk) by a first kernel into an L2-sized scratch; one block per (batch,
head) then applies the decays and multiplies.

`ssd_plain` is the plain PyTorch version (`repro`'s `_xla_chunked_ssd`);
`launches` counts calls that launch the kernels (two launches a call). No
single PyTorch call computes this function.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MAX_HEAD_DIM = 64
MAX_D_STATE = 128

#: calls that launched the CUDA kernels (one C·Bᵀ pass and one head pass
#: each) since the last reset (set to 0 to reset)
launches = 0
#: the f32 operations and bytes of those calls (`work`)
flops = 0.0
moved_bytes = 0.0


def work(bsz: int, s: int, h: int, p: int, n: int, q: int,
         with_state0: bool, want_state: bool) -> tuple:
    """(bytes, f32 operations) one call needs, as chip_smoke.py's bound
    column reckons them: each input read and each output written once;
    C·Bᵀ once per (batch row, chunk) and M·(x·dt) per head, both over their
    causal half; C·S_prev for each chunk with a carried state, and the
    state update for each chunk whose state is used (by the next chunk, or
    returned). Exps and scalings are not counted."""
    nc = s // q
    tri = q * (q + 1) // 2
    carried = nc - 1 + int(with_state0)
    updates = nc - 1 + int(want_state)
    ops = (2.0 * bsz * nc * n * tri + 2.0 * bsz * h * nc * p * tri
           + 2.0 * bsz * h * q * n * p * (carried + updates))
    n_bytes = 4.0 * (2 * bsz * s * h * p + bsz * s * h + h + 2 * bsz * s * n
                     + bsz * h * p * n * (int(with_state0) + int(want_state)))
    return n_bytes, ops


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor,
              state0: Optional[torch.Tensor], chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch: a loop over chunks, dense products
    within. Returns (y [B,S,H,P], state [B,H,P,N] f32)."""
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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_attributes(chunk: int) -> dict:
    """The three kernels as built for a call with this chunk on the current
    CUDA device: registers and local memory per thread, static and dynamic
    shared memory per block, resident blocks per SM."""
    from repro_torch.kernels import build
    fn = build.load("ssd_scan").ssd_scan_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 15)()
    build.check(fn(chunk, ctypes.addressof(info)), "ssd_scan_attributes")
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm")
    return {name: dict(zip(keys, info[5 * k:5 * k + 5])) for k, name in
            enumerate(("ssd_cb_kernel", "ssd_kernel<false>",
                       "ssd_kernel<true>"))}


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  state0: Optional[torch.Tensor], chunk: int,
                  want_state: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernels on f32 CUDA tensors (made contiguous here).
    Returns (y [B,S,H,P], state [B,H,P,N]), or (y, None) when want_state
    is False. Shapes, types and sizes are checked before any launch."""
    global launches, flops, moved_bytes
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
    state = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if want_state else None)
    # C·Bᵀ of every chunk: rows of the chunk length rounded up to 4 floats
    cb = torch.empty((bsz * s * (-(-chunk // 4) * 4),), dtype=torch.float32,
                     device=x.device)
    from repro_torch.kernels import build
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), None if s0 is None else s0.data_ptr(),
                    y.data_ptr(), None if state is None else state.data_ptr(),
                    cb.data_ptr(), bsz, s, h, p, n, chunk, stream)
    build.check(status, "ssd_scan_f32")
    launches += 1
    n_bytes, ops = work(bsz, s, h, p, n, chunk, s0 is not None, want_state)
    flops += ops
    moved_bytes += n_bytes
    return y, state
