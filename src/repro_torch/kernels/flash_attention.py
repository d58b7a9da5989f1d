"""Flash attention forward: online-softmax attention, causal / local window
/ GQA, q rows the last Sq of Skv positions.

Replaces the TPU kernel `repro/kernels/flash_attention.py:
flash_attention_pallas` (body `_flash_kernel`) with the hand-written CUDA
kernel in `csrc/flash_attention.cu` (f32, instances at head_dim 16, 32,
64, 96, 128, 192 and 256). Any other head_dim up to 256 is zero-padded up
to the next instance (the reference pads to a multiple of 128), the
scale taken from the unpadded head_dim, and the result sliced back;
above 256 the wrapper raises.

Bound on the H100 at OPT-125M's shape ([40,12,64,64], causal): bytes,
31.5 MB of q/k/v/out, ≥ 9.4 µs at 3.35 TB/s. At recurrentgemma-2b's
(q [40,10,64,256] against one kv head [40,1,64,256], causal, window
2048): bytes, 57.7 MB, ≥ 17.2 µs; its 0.85 GFLOP need 12.7 µs at
67 TFLOP/s. At yi-6b's prefill (q [4,32,32,128] on four kv heads
[4,4,32,128], causal): bytes, 4.7 MB, ≥ 1.4 µs. At the MLA heads, q, k
and v of one shape, causal: minicpm3-4b's [40,40,64,96], bytes, 157.3 MB,
≥ 47 µs; deepseek-v2's [40,128,64,192], bytes, 1.007 GB, ≥ 300 µs. At
head_dim ≤ 96 each
query row's accumulator stays in registers, split over 4 lanes, with
key/value tiles of 32 rows copied by `cp.async` into two buffers. At
head_dim 128, 192 and 256 one persistent block an SM walks work items of 80
(q head, position) rows of one kv head's query group, so each K/V tile is
copied once for the whole group; every copy is a TMA bulk copy, and both
products are register-blocked f32 FMA from shared memory. Scores and
probabilities never reach device memory, and key tiles no row of the
block can see are skipped.

`attention_plain` is the plain PyTorch version (the full-softmax oracle of
`repro.kernels.ref.attention_ref`); `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: head dims the CUDA source has an instance for; others pad up to one
SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D] → [B, Hq, Sq, D]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_attributes(d: int = 256) -> dict:
    """The head_dim-d instance (`flash_fwd_small_kernel<d>` at d ≤ 96,
    `flash_fwd_group_kernel<d>` at 128, 192 and 256) as built on the
    current CUDA device: registers and local memory per thread, static
    and dynamic shared memory per block, resident blocks per SM, threads,
    query rows and keys of a K/V tile per block."""
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 8)()
    build.check(fn(d, ctypes.addressof(info)), "flash_attention_attributes")
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads", "rows", "key_tile")
    return dict(zip(keys, info))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous f32 CUDA tensors; a head_dim
    without an instance runs zero-padded up to the next one."""
    global launches
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    if k.shape != v.shape or bk != b or dk != d:
        raise ValueError(f"attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not line up")
    if hq % hkv or sq > skv:
        raise ValueError("attention: want Hq % Hkv == 0 and Sq <= Skv")
    if d > SUPPORTED_HEAD_DIMS[-1]:
        raise ValueError(f"attention: head_dim {d} is above the CUDA "
                         f"kernel's largest, {SUPPORTED_HEAD_DIMS[-1]}")
    for t in (q, k, v):
        if t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError("attention: q, k, v must be contiguous f32 on "
                             "one CUDA device")
    if window is not None and window <= 0:
        raise ValueError(f"attention: window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    d_run = next(x for x in SUPPORTED_HEAD_DIMS if x >= d)
    if d_run != d:
        # zeros add nothing to q·k, and give zero output columns
        q, k, v = (torch.nn.functional.pad(t, (0, d_run - d))
                   for t in (q, k, v))
    from repro_torch.kernels import build
    fn = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d_run, float(scale), int(bool(causal)),
                0 if window is None else int(window), stream)
    build.check(status, "flash_attention_f32")
    launches += 1
    return out if d_run == d else out[..., :d].contiguous()
