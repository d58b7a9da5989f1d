"""flash_attention's bf16 kernel on the tensor cores, its arithmetic
modelled on the CPU: Q·Kᵀ exact in one bf16 pass, P in two bf16 pieces.

The CUDA kernel (`csrc/flash_attention.cu`: `flash_fwd_bf16_kernel`,
`bf16_mma_qk`, `bf16_split2`, `bf16_mma2`, `quotient_rn`) runs only on the
card; the model here repeats its arithmetic with torch and is used by
nothing in the package:

- S: for each 16-deep k-step the 16 products of bf16 values, exact, summed
  and rounded once to f32, then added to S in f32; S scaled once after;
- the online softmax per key tile of the kernel's length (32 keys): the
  tile's max, alpha = exp(m - m_new), P = exp(s - m_new) and l in f32;
- P V: hi = P rounded to bf16, lo = (P - hi) rounded to bf16, and per
  16-key block acc += lo·V, then acc += hi·V, the products exact and each
  sum rounded once to f32, a block's 16 keys the tile's keys in order;
- the output divided by max(l, 1e-30) and rounded once to bf16, to nearest
  even (the kernel divides by a reciprocal and one correction, which is
  the quotient bitwise: checked here too).

It is held within one bf16 ulp (chip_smoke's `within_bf16_ulp` rule) of
`repro`'s `flash_attention_pallas` in interpret mode on the same bf16
inputs, run once in a subprocess, at head dims 16, 32, 64, 128 and 96
(zero-padded to 128), causal and not, GQA, a window, Sq < Skv and a ragged
Skv over several tiles. P in one bf16 piece (as SDPA in bf16 forms it)
reads further from the reference, and scaling S after the products stays
within 1e-6 of the largest score of scaling Q first.
"""
import math
import os
import subprocess
import sys
import tempfile
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
BK = 32          # keys a K/V tile (Bf16Shape<D>::kBK)
STEP = 16        # the bf16 mma's depth, and P V's key block
INSTANCES = (16, 32, 64, 128)
# label: q shape, k/v shape, causal, window
CASES = {
    "16 non-causal": ((2, 4, 33, 16), (2, 4, 33, 16), False, None),
    "32 causal": ((2, 4, 40, 32), (2, 4, 40, 32), True, None),
    "64 causal": ((2, 3, 64, 64), (2, 3, 64, 64), True, None),
    "64 GQA window Sq<Skv": ((2, 8, 48, 64), (2, 2, 80, 64), True, 32),
    "64 ragged Skv over tiles": ((1, 6, 37, 64), (1, 2, 150, 64), True,
                                 None),
    "64 non-causal Sq<Skv": ((1, 4, 20, 64), (1, 4, 100, 64), False, None),
    "128 GQA": ((2, 8, 32, 128), (2, 2, 32, 128), True, None),
    "96 padded to 128": ((2, 4, 37, 96), (2, 4, 37, 96), True, None),
}


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 → the f32 value of its bf16 rounding, to nearest even (torch's
    cast, as __float2bfloat16_rn)."""
    return x.to(torch.bfloat16).to(torch.float32)


def split2(p: torch.Tensor):
    """bf16_split2: (hi, lo), hi = p rounded to bf16, lo = p - hi (exact in
    f32) rounded to bf16."""
    hi = bf16_rn(p)
    return hi, bf16_rn(p - hi)


def _inputs(case: str):
    """Seeded q, k, v of a case: bf16 values held in f32."""
    qs, ks, _, _ = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case) + 101)
    return [bf16_rn(torch.from_numpy(rng.standard_normal(s)
                                     .astype(np.float32)))
            for s in (qs, ks, ks)]


def scores_model(q, k, scale):
    """S for q [.., Sq, D] and one key tile k [.., n, D] as the kernel
    forms it: each 16-deep k-step's exact products summed and rounded to
    f32, added to S in f32, then S scaled once."""
    s = torch.zeros(q.shape[:-1] + k.shape[-2:-1], dtype=torch.float32)
    for d0 in range(0, q.shape[-1], STEP):
        z = (q[..., d0:d0 + STEP].double()
             @ k[..., d0:d0 + STEP].double().transpose(-1, -2))
        s = s + z.float()
    return s * torch.tensor(scale, dtype=torch.float32)


def kernel_model(q, k, v, causal, window, pieces=2, record=None):
    """`flash_fwd_bf16_kernel`'s arithmetic on bf16 values held in f32:
    [B, Hq, Sq, D] on [B, Hkv, Skv, D] → the bf16 output, in f32. With
    pieces=1, P V takes P rounded to bf16 alone (another function); each
    tile's (P, hi, lo) is appended to `record` if given."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    d_run = next(x for x in INSTANCES if x >= d)
    pad = (0, d_run - d)
    q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    q_pos = torch.arange(sq) + (skv - sq)
    m = torch.full((b, hq, sq), -math.inf, dtype=torch.float32)
    l = torch.zeros((b, hq, sq), dtype=torch.float32)
    acc = torch.zeros((b, hq, sq, d_run), dtype=torch.float32)
    for t0 in range(0, skv, BK):
        n = min(BK, skv - t0)
        s = scores_model(q, k[:, :, t0:t0 + n], scale)
        k_pos = torch.arange(t0, t0 + n)
        seen = torch.ones((sq, n), dtype=torch.bool)
        if causal:
            seen &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            seen &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~seen, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None]
        hi, lo = split2(p)
        if record is not None:
            record.append((p, hi, lo))
        parts = (lo, hi) if pieces == 2 else (bf16_rn(p),)
        vt = v[:, :, t0:t0 + n].double()
        for j0 in range(0, n, STEP):
            keys = slice(j0, min(j0 + STEP, n))
            for part in parts:
                acc = (acc.double() + part[..., keys].double()
                       @ vt[..., keys, :]).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return bf16_rn(out)[..., :d]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (chip_smoke's `bf16_ulp`)."""
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


def within_bf16_ulp(got: torch.Tensor, ref: torch.Tensor) -> float:
    """chip_smoke's `within_bf16_ulp` rule: the largest |got − ref| in bf16
    ulps of |ref|, or of max|ref| / 256 where a sum cancels toward zero."""
    ref = ref.double()
    tol = bf16_ulp(torch.clamp_min(ref.abs(), float(ref.abs().max()) / 256))
    return float(((got.double() - ref).abs() / tol).max())


# `repro`'s flash_attention_pallas in interpret mode on the saved bf16 bits
# of CASES' inputs (zero-padded to a multiple of 128, as repro's
# ops.attention pads them, the scale from the unpadded head dim), each
# result saved as f32: run in a fresh process, importing neither torch nor
# this module
_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_pallas
d = np.load(sys.argv[1], allow_pickle=True)
res = {}
for i, (causal, window) in enumerate(d["flags"].tolist()):
    q, k, v = (jax.lax.bitcast_convert_type(jnp.asarray(d[f"{a}{i}"]),
                                            jnp.bfloat16) for a in "qkv")
    dim = q.shape[-1]
    pad = ((0, 0), (0, 0), (0, 0), (0, (-dim) % 128))
    q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
    y = flash_attention_pallas(q, k, v, causal=bool(causal),
                               window=None if window < 0 else int(window),
                               scale=1.0 / dim ** 0.5, interpret=True)
    res[f"case{i}"] = np.asarray(y[..., :dim].astype(jnp.float32))
np.savez(sys.argv[2], **res)
"""


def _bits(a: torch.Tensor) -> np.ndarray:
    """bf16 values held in f32 → their 16 bits."""
    return (a.numpy().view(np.uint32) >> 16).astype(np.uint16)


@pytest.fixture(scope="module")
def ref():
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        out = os.path.join(tmp, "ref.npz")
        arrays = {"flags": np.array(
            [(int(c), -1 if w is None else w)
             for _, _, c, w in CASES.values()], dtype=np.int64)}
        for i, case in enumerate(CASES):
            for name, t in zip("qkv", _inputs(case)):
                arrays[f"{name}{i}"] = _bits(t)
        np.savez(inputs, **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=str(ROOT / "src"))
        subprocess.run([sys.executable, "-c", _REFERENCE, inputs, out],
                       env=env, check=True, timeout=300, cwd=ROOT)
        with np.load(out) as data:
            yield {case: torch.from_numpy(data[f"case{i}"])
                   for i, case in enumerate(CASES)}


@pytest.fixture(scope="module")
def models():
    """Each case's model output, with two pieces and with one."""
    out = {}
    for case, (_, _, causal, window) in CASES.items():
        q, k, v = _inputs(case)
        out[case] = (kernel_model(q, k, v, causal, window),
                     kernel_model(q, k, v, causal, window, pieces=1))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_the_pallas_kernel(ref, models, case):
    """Within one bf16 ulp of repro's flash_attention_pallas in interpret
    mode on the same bf16 inputs; P in one bf16 piece reads further."""
    two, one = models[case]
    assert two.shape == ref[case].shape
    err_two = within_bf16_ulp(two, ref[case])
    assert err_two <= 1.0
    assert within_bf16_ulp(one, ref[case]) > err_two


@pytest.mark.parametrize("case", ["64 causal", "128 GQA", "16 non-causal"])
def test_split_puts_p_back(case):
    """hi + lo is P to within 2^-16 of the largest P of its row (about
    2^-17 of P itself), each piece a bf16 value, and lo at most half a bf16
    ulp of hi."""
    _, _, causal, window = CASES[case]
    record = []
    kernel_model(*_inputs(case), causal, window, record=record)
    for p, hi, lo in record:
        for piece in (hi, lo):
            assert torch.equal(piece, bf16_rn(piece))
        row_max = p.amax(-1, keepdim=True)
        assert bool(((hi + lo - p).abs() <= 2.0 ** -16 * row_max).all())
        assert bool((lo.abs() <= bf16_ulp(hi) / 2).all())


@pytest.mark.parametrize("case", ["64 causal", "128 GQA", "32 causal"])
def test_scaling_s_after_stays_near_scaling_q_first(case):
    """S = (Q Kᵀ) scale, each k-step rounded to f32, against (Q scale) Kᵀ
    as the reference forms it (the scaled q rounded to f32, the products
    summed in f64): within 1e-6 of the largest |score|."""
    q, k, _ = _inputs(case)
    d = q.shape[-1]
    k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    scale = 1.0 / math.sqrt(d)
    after = scores_model(q, k, scale).double()
    first = ((q * torch.tensor(scale, dtype=torch.float32)).double()
             @ k.double().transpose(-1, -2))
    assert float((after - first).abs().max()) <= 1e-6 * float(
        first.abs().max())


def _rn32(x: Fraction) -> float:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        key = (abs(Fraction(float(c)) - x),
               int(np.float32(c).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return float(best[1])


def test_reciprocal_and_correction_is_the_quotient():
    """quotient_rn: q = x·rn(1/d), r = x − q·d (exact by fma), rn(q + r /
    d's reciprocal) equals the f32 quotient x / d bitwise, on the model's
    accumulators and normalizers and on normalizers whose significand is
    all ones or a power of two."""
    q, k, v = _inputs("64 ragged Skv over tiles")
    d = q.shape[-1]
    acc = (torch.softmax(q @ k.repeat_interleave(3, 1).transpose(-1, -2)
                         / math.sqrt(d), -1) @ v.repeat_interleave(3, 1))
    rng = np.random.default_rng(7)
    xs = np.concatenate([acc.flatten().numpy()[:1500],
                         rng.standard_normal(300).astype(np.float32)
                         * np.float32(37.5)])
    dens = np.concatenate([
        (1 + rng.random(1500) * 150).astype(np.float32),
        np.float32([2.0 ** (e % 20) * (2 - 2.0 ** -23) for e in range(150)]),
        np.float32([2.0 ** (e % 20) for e in range(150)])])
    for x, den in zip(xs.tolist(), dens.tolist()):
        inv = _rn32(1 / Fraction(den))
        qt = _rn32(Fraction(x) * Fraction(inv))
        r = _rn32(Fraction(x) - Fraction(qt) * Fraction(den))
        got = _rn32(Fraction(qt) + Fraction(r) * Fraction(inv))
        want = float(np.float32(x) / np.float32(den))
        assert got == want, (x, den)
