"""The reference's random draws: jax's threefry2x32 PRNG, on torch tensors.

`repro` draws its OTA noise, its digital dither and its initial weights
with `jax.random` under the partitionable threefry
(`jax_threefry_partitionable=True`, jax 0.9.0's default). This module
computes the same draws on any device, so a port run and a `repro` run
from the same seed start from the same weights and see the same noise:

* `threefry_2x32` (jax/_src/prng.py `threefry_2x32` and the
  `threefry2x32_p` lowering): 20 rounds in 5 groups of 4, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24), key injection with 0x1BD11BDA;
* `key` (`_threefry_seed`), `fold_in` (`_threefry_fold_in`), `split`
  (`_threefry_split_foldlike`), `random_bits` (32-bit:
  `_threefry_random_bits_partitionable`, bits1 ^ bits2), whose counters
  are the flat element index as (hi, lo) words (`iota_2x32_shape`);
* `uniform` (jax/_src/random.py `_uniform`: the mantissa trick, then
  `· (max − min) + min`, then `max(min, ·)`) and `normal` (`_normal_real`:
  `sqrt(2) · erf_inv(u)` with u uniform on [nextafter(−1, 0), 1));
* `bernoulli` (`_bernoulli`, mode "low": `uniform(key, shape) < p`) and
  `permutation` (`_shuffle`: ceil(3·ln n / ln(2³² − 1)) rounds, each
  splitting the key, drawing 32 random bits of the subkey per element
  and stable-sorting by them).

A key is an int64 tensor [..., 2] holding the two uint32 words (hi, lo),
as `jax.random.key_data` gives them; leading dims are a batch of keys, and
a draw from a batch of keys is the draws of each key stacked (what a
`jax.vmap` over keys gives). Words are held in int64 and masked to 32 bits
after every add and shift, so no op relies on unsigned or wrapping
arithmetic, which torch lacks on CUDA.

Bits, keys and uniforms equal jax's bit for bit. Normals differ from
`jax.random.normal` in the last bits only through `log1p`: `erf_inv` is
XLA's f32 `ErfInv` (Giles' polynomial), each Horner step one
multiply-add rounded once, as XLA's CPU compiler contracts it; here a
product of two f32 values is exact in f64, so the step runs in f64 and
rounds to f32 (a double rounding, which differs from the fused one only
when the f64 sum lands on an f32 tie). `log1p` runs in f64 and rounds to
f32 too, so the CPU and the card give the same bits; XLA's own f32
`log1p` differs from that by an ulp or two, and the tests hold normals to
4 ulp of jax's.

Element i of a draw depends only on the key and i, so a draw of more than
`SLICE` elements is taken in slices of its flat range with the same bits
as one whole draw, and the int64 and f64 temporaries stay a few tens of
MB whatever the leaf's size.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: a draw takes at most this many elements (over all its keys) at a time
SLICE = 1 << 22

# XLA's f32 ErfInv: Giles' coefficients for w < 5 and for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def _hash(k1, k2, x1, x2):
    """threefry2x32_p on uint32 words in int64 tensors (broadcast)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _words(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device) \
        if not isinstance(x, torch.Tensor) else x.to(device=device,
                                                     dtype=torch.int64)


def threefry_2x32(keypair, count) -> torch.Tensor:
    """jax's `prng.threefry_2x32(keypair, count)`: the flat count split in
    halves (an odd count padded with a 0) hashed as (x1, x2) pairs, the
    two outputs concatenated. Words are int64 tensors (or arrays)."""
    k1, k2 = keypair
    count = _words(count, None)
    device = count.device
    k1, k2 = _words(k1, device), _words(k2, device)
    flat = count.reshape(-1)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    y1, y2 = _hash(k1, k2, flat[:half], flat[half:])
    return torch.cat([y1, y2])[:n].reshape(count.shape)


def key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.key(seed)`'s data: the hi and lo words of the seed as a
    64-bit integer (seeds in [0, 2³²) give [0, seed], as under jax's
    default 32-bit mode)."""
    s = int(seed)
    return torch.tensor([(s >> 32) & MASK, s & MASK], dtype=torch.int64,
                        device=device)


def key_data(k: torch.Tensor) -> np.ndarray:
    """The key's two words as the uint32 array `jax.random.key_data`
    returns."""
    return k.cpu().numpy().astype(np.uint32)


def wrap_key_data(data, device="cpu") -> torch.Tensor:
    """A key from its uint32 words [..., 2] (`jax.random.wrap_key_data`)."""
    return _words(np.asarray(data, dtype=np.uint32), device) & MASK


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: the hash of the count (0, data). Keys
    [..., 2] and data broadcast against each other."""
    d = _words(data, k.device) & MASK
    y1, y2 = _hash(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)` → [..., num, 2]: key i is the hash of the
    count (0, i), so `split(k, n)[..., i, :]` equals `fold_in(k, i)`."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = _hash(k[..., 0, None], k[..., 1, None], torch.zeros_like(lo),
                   lo)
    return torch.stack([y1, y2], dim=-1)


def _bits(k1, k2, a: int, b: int) -> torch.Tensor:
    """32-bit draws for flat counters [a, b): bits1 ^ bits2."""
    i = torch.arange(a, b, dtype=torch.int64, device=k1.device)
    y1, y2 = _hash(k1, k2, i >> 32, i & MASK)
    return y1 ^ y2


def _draw(k: torch.Tensor, shape: Sequence[int], fn, dtype) -> torch.Tensor:
    """fn over the bits of every key in k [..., 2] for a draw of `shape`,
    taken in slices of at most SLICE elements."""
    shape = tuple(int(s) for s in shape)
    batch = tuple(k.shape[:-1])
    n = math.prod(shape)
    k1, k2 = k[..., 0, None], k[..., 1, None]
    step = max(1, SLICE // max(1, math.prod(batch)))
    if n <= step:
        return fn(_bits(k1, k2, 0, n)).reshape(batch + shape)
    out = torch.empty(batch + (n,), dtype=dtype, device=k.device)
    for a in range(0, n, step):
        b = min(a + step, n)
        out[..., a:b] = fn(_bits(k1, k2, a, b))
    return out.reshape(batch + shape)


def random_bits(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bits(k, shape, uint32)` as int64 words [..., *shape]."""
    return _draw(k, shape, lambda bits: bits, torch.int64)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """[1, 2) − 1: the top 23 bits as the mantissa of an exponent-0 f32."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c for f32 values, rounded to f32 once as a fused multiply-add
    (XLA's CPU compiler contracts a multiply feeding an add into one): the
    product of two f32 values is exact in f64, so the sum rounds to f64,
    then to f32, which differs from one rounding only when the f64 sum lies
    on an f32 tie."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _scaled(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    span = float(np.float32(hi) - np.float32(lo))
    u = _fma32(_unit(bits), span, float(np.float32(lo)))
    return torch.clamp_min(u, float(np.float32(lo)))


def uniform(k: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`."""
    return _draw(k, shape, lambda bits: _scaled(bits, minval, maxval),
                 torch.float32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv: w = −log1p(−x²); for w < 5 a polynomial in
    w − 2.5, else in √w − 3; the result p·x; ±1 → ±inf."""
    w = -torch.log1p(-(x * x).to(torch.float64)).to(torch.float32)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    w64 = w.to(torch.float64)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for c_small, c_large in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, c_small, c_large).to(torch.float64)
        p = _fma32(p, w64, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.normal(k, shape, float32)`."""
    return _draw(k, shape, lambda bits: _SQRT2 * erf_inv(
        _scaled(bits, _NORMAL_LO, 1.0)), torch.float32)



def bernoulli(k: torch.Tensor, p: float = 0.5,
              shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bernoulli(k, p, shape)` (f32 p): uniform(k, shape) < p,
    as a bool tensor."""
    return uniform(k, shape) < float(np.float32(p))


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(k, n)`: arange(n) shuffled by jax's
    `_shuffle`, as int64 [..., n] for keys [..., 2]. Each round takes
    key, subkey = split(key) and stable-sorts the current order by
    random_bits(subkey, (n,)); n = 1 (or 0) takes no round."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=k.device).expand(
        tuple(k.shape[:-1]) + (n,))
    for _ in range(rounds):
        pair = split(k)
        k, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x.contiguous()
