"""perturbed_matmul_bf16's arithmetic on the tensor cores, modelled on the
CPU: w + eps·z (f32) split into three bf16 pieces, and x (bf16) times the
pieces as three exact products summed in f32.

The CUDA kernel (`csrc/perturbed_matmul.cu`: `bf16_split3`, `bf16_mma3`)
runs only on the card; the model here repeats its arithmetic with numpy
and is used by nothing in the package:

- the split: hi = v rounded to bf16 to nearest even, mid = v − hi rounded
  toward zero, lo = v − hi − mid rounded toward zero, each subtraction
  exact in f32;
- the product: for each 16-deep block of K, acc += x·lo, then x·mid, then
  x·hi, each 16 exact products summed into the f32 accumulator; the
  output rounded once to bf16, to nearest even.

It is held (a) to put v back exactly wherever three bf16 pieces can hold
it, and to round like v where they cannot, (b) within one bf16 ulp of
`repro`'s `perturbed_matmul_pallas` in interpret mode on the same inputs,
and (c) to the identity probe: x = I gives what `seeded_axpy_plain`
writes in bf16, bitwise.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.kernels import seeded_axpy as sa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EPS = np.float32(1e-3)
# (M, K, N, seed, counter offset): a K a whole number of 16-deep blocks,
# and a ragged K whose counters wrap past 2^32
CASES = ((24, 48, 40, 0x9E37, 1234), (37, 203, 130, 77, 2**32 - 7777))
SUB = 2.0 ** -133            # bf16's smallest subnormal


def bf16_rn(v: np.ndarray) -> np.ndarray:
    """f32 → the f32 value of its bf16 rounding, to nearest even (finite
    v), as __float2bfloat16_rn."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def bf16_rz(v: np.ndarray) -> np.ndarray:
    """f32 → its bf16 rounding toward zero, as __float2bfloat16_rz."""
    return (v.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFF0000)).view(np.float32)


def split3(v: np.ndarray):
    """bf16_split3: (lo, mid, hi), each an f32 array of bf16 values."""
    v = v.astype(np.float32)
    hi = bf16_rn(v)
    r = v - hi
    mid = bf16_rz(r)
    lo = bf16_rz(r - mid)
    return lo, mid, hi


def tc_product(x: np.ndarray, v: np.ndarray) -> np.ndarray:
    """x [M, K] (bf16 values) @ v [K, N] (f32) as the kernel forms it: per
    16-deep block, acc += x·lo, x·mid, x·hi (exact products, the sum
    rounded to f32), then rounded once to bf16."""
    m, k = x.shape
    kp = -(-k // 16) * 16
    xp = np.zeros((m, kp), np.float64)
    xp[:, :k] = x
    pieces = []
    for piece in split3(v):
        pp = np.zeros((kp, v.shape[1]), np.float64)
        pp[:k] = piece
        pieces.append(pp)
    acc = np.zeros((m, v.shape[1]), np.float32)
    for k0 in range(0, kp, 16):
        for pp in pieces:
            acc = (acc.astype(np.float64)
                   + xp[:, k0:k0 + 16] @ pp[k0:k0 + 16]).astype(np.float32)
    return bf16_rn(acc)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (chip_smoke's `bf16_ulp`)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def within_bf16_ulp(got: np.ndarray, ref: np.ndarray) -> float:
    """chip_smoke's `within_bf16_ulp` rule: the largest |got − ref| in bf16
    ulps of |ref|, or of max|ref| / 256 where a sum cancels toward zero."""
    tol = bf16_ulp(np.maximum(np.abs(ref), np.abs(ref).max() / 256))
    return float((np.abs(got.astype(np.float64) - ref) / tol).max())


def _inputs(m, k, n, case):
    """Seeded x [M, K] and w [K, N], both bf16 values held in f32."""
    rng = np.random.default_rng(31 + case)
    x = bf16_rn(rng.standard_normal((m, k)).astype(np.float32))
    w = bf16_rn((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    return x, w


def _bits(a: np.ndarray) -> np.ndarray:
    """bf16 values held in f32 → their 16 bits."""
    return (a.view(np.uint32) >> 16).astype(np.uint16)


# `repro`'s perturbed_matmul_pallas in interpret mode on the saved bf16 bits
# of CASES' inputs, each result saved as f32: run in a fresh process, under
# the XLA flags the fixture sets, importing neither torch nor this module
_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.kernels.perturbed_matmul import perturbed_matmul_pallas
d = np.load(sys.argv[1])
res = {}
for i, (seed, off) in enumerate(d["streams"].tolist()):
    x, w = (jax.lax.bitcast_convert_type(jnp.asarray(d[f"{a}{i}"]),
                                         jnp.bfloat16) for a in "xw")
    y = perturbed_matmul_pallas(x, w, jnp.uint32(seed), jnp.uint32(off),
                                float(d["eps"]), interpret=True)
    res[f"case{i}"] = np.asarray(y.astype(jnp.float32))
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="module")
def ref():
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        out = os.path.join(tmp, "ref.npz")
        arrays = {"eps": EPS, "streams": np.array(
            [(seed, off) for *_, seed, off in CASES], dtype=np.uint64)}
        for i, (m, k, n, _, _) in enumerate(CASES):
            x, w = _inputs(m, k, n, i)
            arrays[f"x{i}"], arrays[f"w{i}"] = _bits(x), _bits(w)
        np.savez(inputs, **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=str(ROOT / "src"))
        subprocess.run([sys.executable, "-c", _REFERENCE, inputs, out],
                       env=env, check=True, timeout=300, cwd=ROOT)
        with np.load(out) as data:
            yield {key: data[key] for key in data.files}


def _v(w: np.ndarray, seed: int, off: int) -> np.ndarray:
    """w + eps·z(seed, off) in f32, as the kernel forms it (the port's
    counter-hash stream, two roundings)."""
    out = sa.seeded_axpy_plain(torch.from_numpy(w), seed,
                               torch.tensor(EPS), off)
    return out.numpy()


def _split_values() -> dict:
    """The v the split is held on, by kind."""
    rng = np.random.default_rng(5)
    mant = rng.integers(0, 1 << 23, 4096, dtype=np.uint32)
    expo = rng.integers(-110, 127, 4096)
    sign = np.where(rng.random(4096) < 0.5, -1.0, 1.0)
    normal = (sign * (1 + mant / 2.0 ** 23) * 2.0 ** expo).astype(np.float32)
    # bf16 values 2^-110 to 2^126
    top = rng.integers(0x0880, 0x7E80, 256, dtype=np.uint32) << 16
    # exactly half a bf16 ulp above a bf16 value, hi's last bit odd or even
    half_ulp = (top | 0x8000).view(np.float32)
    # residuals v − hi that lie half a bf16 ulp of their own above a bf16
    # value: their top bit p, the tie bit p − 8, and an odd last bit p − 7
    p = np.arange(8, 15, dtype=np.uint32)
    low = np.concatenate([(1 << p) | (1 << (p - 8)),
                          (1 << p) | (1 << (p - 7)) | (1 << (p - 8))])
    tie_rest = (top[:, None] | low[None, :]).ravel().view(np.float32)
    # around 2^-126: subnormal and normal f32 with every low bit, and
    # multiples of 2^-133 there (bf16 subnormals and their sums)
    around = np.concatenate([
        (np.uint32(0x00800000) + np.arange(-300, 300)).astype(np.uint32)
        .view(np.float32),
        ((1 + mant[:256] / 2.0 ** 23) * 2.0 ** -127).astype(np.float32),
        (rng.integers(1, 1 << 16, 256) * SUB).astype(np.float32)])
    big = np.concatenate([np.float32([3e38, -3e38, 1e38]),
                          (rng.uniform(1e37, 3e38, 256)
                           * np.where(rng.random(256) < 0.5, -1, 1))
                          .astype(np.float32)])
    zeros = np.float32([0.0, -0.0])
    return {"normal": normal, "half_ulp": half_ulp,
            "residual_ties": tie_rest, "near 2^-126": around, "big": big,
            "zeros": zeros}


@pytest.mark.parametrize("kind", ["normal", "half_ulp", "residual_ties",
                                  "near 2^-126", "big", "zeros"])
def test_split_puts_v_back(kind):
    """(a) hi + mid + lo == v bitwise in f32, in the kernel's order ((lo +
    mid) + hi), wherever v's lowest set bit is at or above 2^-133 (bf16's
    smallest subnormal: every |v| >= 2^-110, every value here but some
    near 2^-126); each piece is a bf16 value. Below that three bf16
    pieces cannot hold v: their sum lies between hi and v, within 2^-133
    of v, and rounds to bf16 as v does."""
    v = _split_values()[kind]
    lo, mid, hi = split3(v)
    for piece in (lo, mid, hi):
        assert not (piece.view(np.uint32) & 0xFFFF).any()
    total = (lo + mid) + hi
    exact = np.fmod(v.astype(np.float64), SUB) == 0
    if kind != "near 2^-126":
        assert exact.all()
    assert (np.abs(v[~exact]) < 2.0 ** -110).all()
    np.testing.assert_array_equal(total[exact], v[exact])
    np.testing.assert_array_equal(total.astype(np.float64)[exact],
                                  lo.astype(np.float64)[exact]
                                  + mid[exact] + hi[exact])
    if kind == "near 2^-126":
        assert (~exact).any() and exact.any()
        t, vv, h = (a[~exact].astype(np.float64) for a in (total, v, hi))
        assert (np.abs(vv - t) < SUB).all()
        assert ((t - h) * (vv - t) >= 0).all()
    np.testing.assert_array_equal(bf16_rn(total), bf16_rn(v))


def test_split_models_the_conversions():
    """The model's roundings are the card's: bf16_rn as torch's bf16 cast
    (round to nearest even), bf16_rz as dropping the low 16 bits."""
    v = np.concatenate(list(_split_values().values()))
    got = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16_rn(v), got)
    rz = bf16_rz(v).astype(np.float64)
    assert (np.abs(rz) <= np.abs(v.astype(np.float64))).all()
    # below 2^-126 bf16's spacing is its smallest subnormal's
    assert (np.abs(v - rz) < np.maximum(bf16_ulp(v), SUB)).all()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_three_piece_product_matches_the_pallas_kernel(ref, case):
    """(b) x·lo + x·mid + x·hi, products exact, f32 sums in 16-deep blocks,
    rounded once: within one bf16 ulp (chip_smoke's rule) of `repro`'s
    perturbed_matmul_pallas in interpret mode on the same bf16 x and w,
    and of the f32 product in f64 (the function both round)."""
    m, k, n, seed, off = CASES[case]
    x, w = _inputs(m, k, n, case)
    v = _v(w, seed, off)
    got = tc_product(x, v)
    assert within_bf16_ulp(got, ref[f"case{case}"]) <= 1.0
    # the f32 accumulator is a few f32 ulps (2^-16 bf16 ulp each) from the
    # exact sum, so the once-rounded output is within half a bf16 ulp and
    # those few f32 ulps
    exact = x.astype(np.float64) @ v.astype(np.float64)
    assert within_bf16_ulp(got, exact) <= 0.5 + 2.0 ** -10


@pytest.mark.parametrize("case", range(len(CASES)))
def test_identity_probe_is_seeded_axpy(case):
    """(c) x = I: the model accumulates exactly v and rounds it once, what
    `seeded_axpy_plain` writes in bf16, bitwise."""
    _, k, n, seed, off = CASES[case]
    _, w = _inputs(4, k, n, case)
    got = tc_product(np.eye(k, dtype=np.float32), _v(w, seed, off))
    w16 = torch.from_numpy(w).to(torch.bfloat16)
    want = sa.seeded_axpy_plain(w16, seed, torch.tensor(EPS), off)
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want)


def test_identity_probe_near_2_126():
    """(c) on w + eps·z near 2^-112, whose lo pieces fall below 2^-126
    (subnormal, or past bf16's last bit): the probe still rounds to what
    seeded_axpy_plain writes."""
    rng = np.random.default_rng(9)
    w = bf16_rn((rng.standard_normal((64, 48)) * 2.0 ** -112)
                .astype(np.float32))
    eps = torch.tensor(np.float32(2.0 ** -113))
    v = sa.seeded_axpy_plain(torch.from_numpy(w), 67, eps, 99).numpy()
    lo, _, _ = split3(v)
    assert ((lo != 0) & (np.abs(lo) < 2.0 ** -126)).mean() > 0.5
    got = tc_product(np.eye(64, dtype=np.float32), v)
    want = sa.seeded_axpy_plain(torch.from_numpy(w).to(torch.bfloat16), 67,
                                eps, 99)
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want)
