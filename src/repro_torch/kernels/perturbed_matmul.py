"""Fused perturbed matmul: out = x @ (w + eps · z(seed)), z never stored.

Replaces the TPU kernel `repro/kernels/perturbed_matmul.py:
perturbed_matmul_pallas` (body `_pmm_kernel`) with the hand-written CUDA
kernel in `csrc/perturbed_matmul.cu`. Element (k, n) of w draws counter
`off + k·N + n` of the leaf's counter-hash stream (`seeded_axpy`), so a
layer sliced out of a scan-stacked leaf sees the whole leaf's z values.

Bound on the H100 at the main path's shapes (M = 2560 rows of full
OPT-125M; (K, N) ∈ {(768, 768), (768, 3072), (3072, 768)}): f32
operations — 2·M·K·N, e.g. 2·2560·768·3072 = 12.1 GFLOP, at least 0.18 ms
at 67 TFLOP/s, while x, w and out move 17 MB (5 µs). The kernel keeps
plain f32 FMA (no TF32, no tensor cores) in 128 × 128 output tiles with an
8 × 8 register micro-tile per thread. The blocks that read the same w
columns form a thread-block cluster of `CLUSTER` blocks stacked along M:
each draws 1/CLUSTER of every 16 × 128 tile of w + eps·z and stores it
into the shared memory of all of them, so z is drawn M / (128·CLUSTER)
times per weight (5 at M = 2560), and x tiles arrive by `cp.async` ahead
of the product.

bf16 x and w (`perturbed_matmul_bf16`, kernel `pmm_kernel_bf16`), as
`repro`'s kernel: w + eps·z built in f32 (not rounded), f32 accumulation,
the product rounded once to x's dtype. Its products run on the tensor
cores: w + eps·z is split into three bf16 pieces whose sum is it (its 24
significant bits), x (exact in bf16) times each piece is exact in f32, and
three `mma.sync` m16n8k16 bf16 products (x·lo, x·mid, x·hi) accumulate in
f32; its tile rows `BM` and cluster `CLUSTER` are its own. Its bound is
the three products: 3·2·M·K·N at the 989 TFLOP/s of bf16, 0.1466 ms for
one OPT-125M layer's 7 projections at M = 2560. The plain version is
`repro`'s XLA path: w + eps·z resolved in w's dtype (a bf16 leaf rounds
it), the product accumulated in f32, then cast to x's dtype; so in bf16
the two part by w + eps·z's rounding, and `chip_smoke.py` holds the
kernel to the plain version on f32 copies of the same inputs.

`perturbed_matmul_plain` is the plain PyTorch version (resolve w + eps·z,
then `torch.matmul` in f32); `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import seeded_axpy as sa

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0
#: the operations (2·M·K·N) and bytes (x and w read, the product written,
#: each at its element size) of those launches, as chip_smoke.py's bound
#: column reckons them
flops = 0.0
moved_bytes = 0.0
#: blocks per thread-block cluster along M, per dtype: kCluster (f32) and
#: kTcCluster (bf16) of the CUDA source
CLUSTER = {torch.float32: 4, torch.bfloat16: 4}
#: output rows per block, per dtype: BM and kTcBM of the CUDA source
BM = {torch.float32: 128, torch.bfloat16: 128}


def perturbed_matmul_plain(x: torch.Tensor, w: torch.Tensor, seed,
                           off: int, eps: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ (w [K, N] + eps · z(seed, off)), w + eps·z in w's
    dtype, accumulated in f32, in x's dtype."""
    wz = sa.seeded_axpy_plain(w, seed, eps, off)
    return torch.matmul(x.to(torch.float32), wz.to(torch.float32)
                        ).to(x.dtype)


_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p)


def _lib():
    """{dtype: entry} of the built library."""
    return build.entries("perturbed_matmul", "perturbed_matmul", _ARGS)


def kernel_attributes(m: int, n: int, dtype=torch.float32) -> dict:
    """The `dtype` instance as built and launched for an [m, ·] × [·, n]
    call on the current CUDA device: registers and local memory per
    thread, shared memory per block, cluster size and residency, the grid,
    and the tile: output rows and columns a block, K a step, threads a
    block."""
    fn = build.load("perturbed_matmul").perturbed_matmul_attributes
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "cluster", "resident_clusters", "blocks_per_sm", "grid_blocks",
            "block_rows", "block_cols", "block_k", "threads")
    info = (ctypes.c_int * len(keys))()
    build.check(fn(m, n, int(dtype == torch.bfloat16),
                   ctypes.addressof(info)), "perturbed_matmul_attributes")
    return dict(zip(keys, info))


def perturbed_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                          seed: torch.Tensor, off: int, eps: torch.Tensor
                          ) -> torch.Tensor:
    """Launch the CUDA kernel: x [M, K] @ (w [K, N] + eps·z) → [M, N] in
    x's dtype. x and w are contiguous CUDA tensors, both f32 or both bf16;
    seed (one int32 element
    holding the uint32 bits, `sa.seed_tensor`) and eps (one f32 element)
    lie on their device and are read by the kernel from device memory."""
    global launches, flops, moved_bytes
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"perturbed_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not line up as [M,K] @ [K,N]")
    if w.dtype not in build.SUFFIX:
        raise ValueError(f"perturbed_matmul: no kernel for {w.dtype} (f32, "
                         "bf16)")
    for name, t in (("x", x), ("w", w)):
        if t.device != w.device or t.dtype != w.dtype \
                or not t.is_contiguous():
            raise ValueError(f"perturbed_matmul: {name} must be contiguous "
                             f"{w.dtype} on {w.device}")
    if eps.device != w.device or eps.dtype != torch.float32 \
            or eps.numel() != 1:
        raise ValueError(f"perturbed_matmul: eps must be one f32 element on "
                         f"{w.device}")
    sa.check_seed(seed, w.device, "perturbed_matmul")
    m, k = x.shape
    n = w.shape[1]
    if max(m, k, n) >= 2**31:
        raise ValueError("perturbed_matmul: dims must be below 2³¹")
    bm, cluster = BM[w.dtype], CLUSTER[w.dtype]
    if -(-m // (bm * cluster)) * cluster > 65535:
        raise ValueError(f"perturbed_matmul: M = {m} needs more than 65535 "
                         "row blocks")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib()[x.dtype](x.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                             k, n, seed.data_ptr(), int(off) & sa.MASK32,
                             eps.data_ptr(), stream)
    build.check(status, f"perturbed_matmul_{build.SUFFIX[x.dtype]}")
    launches += 1
    flops += 2.0 * m * k * n
    moved_bytes += float(x.element_size()) * (m * k + k * n + m * n)
    return out
