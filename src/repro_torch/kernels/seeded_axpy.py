"""Seeded perturbation: out = w + scale · z(seed), z never stored.

Replaces the TPU kernel `repro/kernels/seeded_axpy.py:seeded_axpy_pallas`
(body `_axpy_kernel`) with the hand-written CUDA kernel in
`csrc/seeded_axpy.cu`.

z[idx] is a pure function of (seed, flat element index): a murmur3 fmix32
counter hash feeding Box–Muller, the stream `repro` draws bitwise on every
backend. This module holds the stream twice:

* the plain PyTorch version (`gaussian_from_counter`, `seeded_axpy_plain`)
  — the uint32 arithmetic runs in int64 masked to 32 bits, and every
  product that could pass 2⁶³ (x·0x846CA68B, seed·0x9E3779B9) is split into
  16-bit halves (`mul32`), so nothing relies on signed overflow; on the
  CPU the Box–Muller step runs on the calling thread (`_box_muller_cpu`);
* the CUDA wrappers (`seeded_axpy_cuda`, `seeded_gather_cuda`), which
  launch the kernels and count their launches in `launches` and
  `gather_launches`.

The kernels read the leaf's stream seed from device memory, as they read
the scale: the wrappers take a one-element int32 tensor on the card
holding the seed's uint32 bits (`seed_tensor`; `zo.seed_row` makes a row
of them), so a captured CUDA graph replays a round with whatever seeds
its input buffer holds, and no host value is baked into a launch. The
plain versions take such a tensor too, read on its device with no host
round trip (so a round on them is captured as well), or a host int.
`seed_value` reads one back on the host.

Leaves are f32 or bf16. A bf16 leaf is widened to f32, w + scale·z formed
in f32 and rounded once to bf16 (to nearest even, as `repro`'s kernel and
XLA's convert do): `seeded_axpy_bf16` and `seeded_gather_bf16` in the CUDA
source, and `.to(w.dtype)` in the plain versions.

Every draw takes a base counter `off` (0 for a whole leaf): a layer sliced
out of a scan-stacked leaf draws counters `off + i` and so continues the
whole leaf's stream (the fused dual forward's `resolve`). The gathered-rows
entry perturbs embedding rows: row `tok` column j draws `off + tok·D + j`,
the bits the row has in the whole-table stream.

Bound on the H100: instruction issue, then bytes. One read and one write
of w (8 bytes per f32 element, 4 per bf16): a θ pass over full OPT-125M's
190.5M elements moves 1.52 GB in f32, at least 0.45 ms at 3.35 TB/s, and
0.76 GB in bf16; z is generated in registers, so device memory sees
nothing else. But every element costs a whole draw, about 105
instructions on the kernel's shortest SASS path, which `chip_smoke.py`
turns into an issue bound above the byte bound in either type.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
# 2π rounded to f32 once, so the plain version multiplies by the very f32
# constant the reference and the kernel use
_TWO_PI_F32 = 6.2831854820251465
_INV24 = 2.0 ** -24

#: leaf types the CUDA kernels take
KERNEL_DTYPES = tuple(build.SUFFIX)

#: launches of the CUDA axpy kernel since the last reset (set to 0 to reset)
launches = 0
#: launches of the CUDA gathered-rows kernel since the last reset
gather_launches = 0
#: beside each launch counter, the f32 operations and the bytes its kernel's
#: launches did since the last reset, reckoned as chip_smoke.py's bound
#: column reckons them: per element 12 operations (two unit conversions
#: and floors, log, ×(−2), sqrt, ×2π, cos, ×r, ×scale, +w; the integer
#: hash is not counted) and two element sizes of bytes (w read, out
#: written: 8 in f32, 4 in bf16); the gather also reads its int64 token ids
flops = 0.0
moved_bytes = 0.0
gather_flops = 0.0
gather_moved_bytes = 0.0


def mul32(x, c: int):
    """(x · c) mod 2³² for 0 ≤ x, c < 2³² — int64 tensors or Python ints.

    c is split into 16-bit halves: x·c_lo and x·c_hi stay below 2⁴⁸."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x):
    """murmur3 finalizer on uint32 values held in int64 tensors or ints."""
    x = x ^ (x >> 16)
    x = mul32(x, _M1)
    x = x ^ (x >> 15)
    x = mul32(x, _M2)
    return x ^ (x >> 16)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → f32 uniform in [2⁻²⁴, 1): the top 24 bits as mantissa."""
    f = (bits >> 8).to(torch.float32) * _INV24
    return torch.clamp_min(f, _INV24)


def _box_muller_cpu(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Box–Muller on CPU tensors with the same f32 steps as the kernel,
    log and cos correctly rounded (evaluated in f64, then rounded).

    torch's CPU log, cos and sqrt go to MKL's vector math library over
    OpenMP threads, and the first such call of a process sometimes returns
    one thread's chunk wrong (up to ~1600 ulp): the library's first-use
    set-up races between the threads. numpy evaluates on the calling
    thread, so the draw no longer depends on which thread computes it."""
    u1n, u2n = u1.numpy(), u2.numpy()
    lg = np.log(u1n.astype(np.float64)).astype(np.float32)
    r = np.sqrt(np.float32(-2.0) * lg)                # IEEE f32 sqrt
    ang = np.float32(_TWO_PI_F32) * u2n
    c = np.cos(ang.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(r * c)


def _seed_bits(seed, device):
    """A leaf seed's uint32 bits: a host int, or (from a one-element int
    tensor holding them, e.g. an element of `zo.seed_row`) an int64 0-d
    tensor on `device`, read without a host round trip, so the plain
    versions too run inside a CUDA graph's capture."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(device=device, dtype=torch.int64) & MASK32
    return int(seed) & MASK32


def gaussian_from_counter(idx: torch.Tensor, seed) -> torch.Tensor:
    """Standard normal z[idx] for int64 counters idx (values < 2³²); `seed`
    a host int or a one-element int tensor (`_seed_bits`)."""
    base = (idx * 2 + mul32(_seed_bits(seed, idx.device), GOLDEN)) & MASK32
    u1 = bits_to_unit(fmix32(base))
    u2 = bits_to_unit(fmix32((base + 1) & MASK32))
    if idx.device.type == "cpu":
        return _box_muller_cpu(u1, u2)
    # on the card: the precise logf/sqrtf/cosf the kernel calls, so the
    # plain version and the kernel agree bitwise
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI_F32 * u2)


def flat_counters(shape, off: int = 0, device="cpu") -> torch.Tensor:
    """int64 counters `off` + flat row-major index, modulo 2³², of `shape`."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return ((idx + (int(off) & MASK32)) & MASK32).reshape(tuple(shape))


def draw_z(shape, seed, device="cpu", off: int = 0) -> torch.Tensor:
    """z(seed) over a leaf of `shape` from counter `off` (with off = 0 the
    plain counterpart of `repro.kernels.ref.draw_z_ref`)."""
    return gaussian_from_counter(flat_counters(shape, off, device), seed)


def seeded_axpy_plain(w: torch.Tensor, seed, scale: torch.Tensor,
                      off: int = 0) -> torch.Tensor:
    """out = w + scale · z(seed) in f32 (two roundings, as the reference),
    in w's dtype (a bf16 leaf: one more rounding, to nearest even)."""
    z = draw_z(w.shape, seed, w.device, off)
    return (w.to(torch.float32) + scale * z).to(w.dtype)


def gather_counters(tokens: torch.Tensor, d: int, off: int = 0
                    ) -> torch.Tensor:
    """[..., d] int64 counters off + tok·d + j of the gathered rows."""
    j = torch.arange(d, dtype=torch.int64, device=tokens.device)
    return (tokens.to(torch.int64)[..., None] * d + j + (int(off) & MASK32)
            ) & MASK32


def seeded_gather_plain(w: torch.Tensor, tokens: torch.Tensor, seed,
                        scale: torch.Tensor, off: int = 0) -> torch.Tensor:
    """Rows w[tokens] + scale · z, each row drawing its whole-table bits."""
    z = gaussian_from_counter(gather_counters(tokens, w.shape[-1], off), seed)
    return (w[tokens].to(torch.float32) + scale * z).to(w.dtype)


def seed_tensor(seed: int, device="cpu") -> torch.Tensor:
    """A leaf seed as the kernels read it: a 0-d int32 tensor holding the
    uint32 bits of `seed`."""
    bits = np.asarray(int(seed) & MASK32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


def seed_value(seed) -> int:
    """A leaf seed as a host int in [0, 2³²): from an int, or from a
    one-element int tensor holding the uint32 bits (on the card this reads
    the device)."""
    return int(seed) & MASK32


def check_seed(seed, device: torch.device, what: str):
    if not isinstance(seed, torch.Tensor) or seed.device != device \
            or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError(f"{what}: seed must be one int32 element on {device}"
                         " (seed_tensor / zo.seed_row); the kernel reads it "
                         "from device memory")


def _check_scale(scale: torch.Tensor, device: torch.device, what: str):
    if scale.device != device or scale.dtype != torch.float32 \
            or scale.numel() != 1:
        raise ValueError(f"{what}: scale must be one f32 element on {device}")


_AXPY_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
              ctypes.c_void_p)
_GATHER_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p)


def _lib():
    """({dtype: axpy entry}, {dtype: gather entry}) of the built library."""
    return (build.entries("seeded_axpy", "seeded_axpy", _AXPY_ARGS),
            build.entries("seeded_axpy", "seeded_gather", _GATHER_ARGS))


def seeded_axpy_cuda(w: torch.Tensor, seed: torch.Tensor,
                     scale: torch.Tensor, out: torch.Tensor, off: int = 0
                     ) -> torch.Tensor:
    """Launch the CUDA kernel: out = w + scale · z(seed), counters from
    `off`, on an f32 or a bf16 leaf. `out` (w's dtype) may be `w` (in
    place). `seed` (one int32 element holding the uint32 bits) and `scale`
    (one f32 element) lie on w's device and are read by the kernel from
    device memory."""
    global launches, flops, moved_bytes
    if w.dtype not in KERNEL_DTYPES:
        raise ValueError(f"seeded_axpy: no kernel for {w.dtype} (f32, bf16)")
    for name, t in (("w", w), ("out", out)):
        if t.device != w.device or t.dtype != w.dtype:
            raise ValueError(f"seeded_axpy: {name} must be {w.dtype} on "
                             f"{w.device}")
    check_seed(seed, w.device, "seeded_axpy")
    _check_scale(scale, w.device, "seeded_axpy")
    if not (w.is_contiguous() and out.is_contiguous()):
        raise ValueError("seeded_axpy: w and out must be contiguous")
    if out.shape != w.shape:
        raise ValueError("seeded_axpy: out must match w")
    fn = _lib()[0][w.dtype]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    status = fn(w.data_ptr(), out.data_ptr(), w.numel(), seed.data_ptr(),
                int(off) & MASK32, scale.data_ptr(), stream)
    build.check(status, f"seeded_axpy_{build.SUFFIX[w.dtype]}")
    launches += 1
    flops += 12.0 * w.numel()
    moved_bytes += 2.0 * w.element_size() * w.numel()
    return out


def seeded_gather_cuda(w: torch.Tensor, tokens: torch.Tensor,
                       seed: torch.Tensor, scale: torch.Tensor, off: int = 0
                       ) -> torch.Tensor:
    """Launch the gathered-rows kernel: [..., D] rows w[tokens] + scale·z,
    in w's dtype. `w` is a contiguous f32 or bf16 [V, D] table; token ids
    must lie in [0, V); `seed` and `scale` as for `seeded_axpy_cuda`."""
    global gather_launches, gather_flops, gather_moved_bytes
    if w.dim() != 2 or w.dtype not in KERNEL_DTYPES \
            or not w.is_contiguous():
        raise ValueError("seeded_gather: w must be a contiguous f32 or bf16 "
                         "[V, D]")
    if tokens.device != w.device or tokens.dtype != torch.int64:
        raise ValueError(f"seeded_gather: tokens must be int64 on {w.device}")
    check_seed(seed, w.device, "seeded_gather")
    _check_scale(scale, w.device, "seeded_gather")
    tok = tokens.contiguous()
    out = torch.empty(tuple(tokens.shape) + (w.shape[1],),
                      dtype=w.dtype, device=w.device)
    fn = _lib()[1][w.dtype]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    status = fn(w.data_ptr(), tok.data_ptr(), out.data_ptr(), tok.numel(),
                w.shape[1], seed.data_ptr(), int(off) & MASK32,
                scale.data_ptr(), stream)
    build.check(status, f"seeded_gather_{build.SUFFIX[w.dtype]}")
    gather_launches += 1
    gather_flops += 12.0 * out.numel()
    gather_moved_bytes += 2.0 * w.element_size() * out.numel() \
        + 8.0 * tok.numel()
    return out
