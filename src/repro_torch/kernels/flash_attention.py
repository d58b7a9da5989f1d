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
[4,4,32,128], causal): bytes, 4.7 MB, ≥ 1.4 µs; at moonshot's training
shape ([40,16,64,128], causal): bytes, 83.9 MB, ≥ 25.0 µs; at a
2048-token prompt (q [1,32,2048,128] on [1,4,2048,128]): operations, its
67.1 M visible pairs in three TF32 passes ≥ 0.208 ms at 495 TFLOP/s. At
the MLA heads, q, k and v of one shape, causal: minicpm3-4b's
[40,40,64,96], bytes, 157.3 MB, ≥ 47 µs; deepseek-v2's [40,128,64,192],
bytes, 1.007 GB, ≥ 300 µs. At head_dim ≤ 64 each query row's accumulator
stays in registers, split over 4 lanes, with key/value tiles of 32 rows
copied by `cp.async` into two buffers. At head_dim 96, 128 and 192
persistent blocks of four 16-row warps and a TMA producer warp walk items
of 64 (q head, position) rows of one kv head's query group, and both
products run on the tensor cores in 3xTF32 (`mma.sync`, f32
accumulators; each warp splits what it loads into TF32 hi and lo). At
head_dim 256 one persistent block an SM walks items of 80 such rows;
there both products are register-blocked f32 FMA from shared memory. In
both kernels each K/V tile is copied once for the
whole group by TMA bulk copies. Scores and probabilities never reach
device memory, and key tiles no row of the item can see are skipped.

bf16 q/k/v (`flash_attention_bf16` in the CUDA source) run the small
kernel at head_dim 16, 32 and 64 and the tensor-core kernel at 128, as
`repro`'s kernel computes them: widened to f32 where they are read, the
softmax and P in f32, the output rounded once to bf16; a head_dim below
128 without a bf16 instance is zero-padded up to the next one, and above
128 a bf16 call raises (ROADMAP A12). Bound: bytes, half the f32 call's.

`attention_plain` is the plain PyTorch version (the full-softmax oracle of
`repro.kernels.ref.attention_ref`); `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: head dims the CUDA source has an instance for; others pad up to one
SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
#: the head dims of its bf16 instances (ROADMAP A12 queues 96, 192, 256)
BF16_HEAD_DIMS = (16, 32, 64, 128)

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0
#: the f32 operations and bytes of those launches (chip_smoke.py's bound
#: column): per visible (query, key) pair 4·d + 3 operations (q·k and p·v,
#: 2·d each, and about 3 for the exp and the sum); q, k, v read and the
#: output written once, at their element size
flops = 0.0
moved_bytes = 0.0


def visible_pairs(sq: int, skv: int, causal: bool = True,
                  window: Optional[int] = None) -> int:
    """(query, key) pairs one head of `attention_plain`'s mask lets
    through: query i sits at key position i + skv − sq, a causal query sees
    the keys up to its own, and a window keeps the `window` newest of
    them."""
    off = skv - sq
    if not causal:
        if window is None:
            return sq * skv
        return sum(skv - max(0, p - window + 1) for p in range(off, skv))
    lo, hi = off + 1, skv              # keys seen by the first, last query
    if window is None or window >= hi:
        return (lo + hi) * sq // 2
    if window <= lo:
        return sq * window
    return (lo + window) * (window - lo + 1) // 2 + (hi - window) * window


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


_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _lib():
    """{dtype: entry} of the built library."""
    return build.entries("flash_attention", "flash_attention", _ARGS)


def kernel_attributes(d: int = 256, dtype=torch.float32) -> dict:
    """The head_dim-d instance (`flash_fwd_small_kernel<d>` at d ≤ 64,
    `flash_fwd_tc_kernel<d>` at 96, 128 and 192, `flash_fwd_group_kernel<d>`
    at 256; in bf16 at 16, 32, 64 and 128) as built on the current CUDA
    device: registers and local memory per thread, static and dynamic
    shared memory per block, resident blocks per SM, threads, query rows
    and keys of a K/V tile per block."""
    lib = build.load("flash_attention")
    fn = lib.flash_attention_bf16_attributes if dtype == torch.bfloat16 \
        else lib.flash_attention_attributes
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
    """Launch the CUDA kernel on contiguous f32 or bf16 CUDA tensors (one
    dtype for all three); a head_dim without an instance runs zero-padded
    up to the next one."""
    global launches, flops, moved_bytes
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
    if q.dtype not in build.SUFFIX:
        raise ValueError(f"attention: no kernel for {q.dtype} (f32, bf16)")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError("attention: q, k, v must be contiguous, of one "
                             "dtype, on one CUDA device")
    dims = BF16_HEAD_DIMS if q.dtype == torch.bfloat16 \
        else SUPPORTED_HEAD_DIMS
    if d > dims[-1]:
        raise NotImplementedError(
            f"attention: bf16 at head_dim {d} has no instance (up to "
            f"{dims[-1]}; ROADMAP A12)")
    if window is not None and window <= 0:
        raise ValueError(f"attention: window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    d_run = next(x for x in dims if x >= d)
    if d_run != d:
        # zeros add nothing to q·k, and give zero output columns
        q, k, v = (torch.nn.functional.pad(t, (0, d_run - d))
                   for t in (q, k, v))
    fn = _lib()[q.dtype]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d_run, float(scale), int(bool(causal)),
                0 if window is None else int(window), stream)
    build.check(status, f"flash_attention_{build.SUFFIX[q.dtype]}")
    launches += 1
    flops += float(b * hq * visible_pairs(sq, skv, causal, window)
                   * (4 * d + 3))
    moved_bytes += float(q.element_size()) * (2 * b * hq * sq * d
                                              + 2 * b * hkv * skv * d)
    return out if d_run == d else out[..., :d].contiguous()
