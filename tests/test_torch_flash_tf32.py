"""Why flash attention's tensor-core kernel (head_dim 96, 128 and 192)
takes three TF32 passes, shown on the CPU with torch alone.

TF32 is emulated as the kernel's `tc_split` forms it: hi = x rounded to 10
mantissa bits (to nearest, ties away, as cvt.rna.tf32.f32), lo = x - hi,
and the tensor core reading only each operand's top 19 bits. Each k-step
of 8 sums its products exactly and rounds once to f32, as the kernel sums
a k-step's three products from zero before adding them to the scores.
The gate is chip_smoke.py's flash gate: allclose to `attention_plain` at
rtol = atol = 1e-5.

- One pass (hi.hi) misses the gate by tens of times at head_dim 96, 128
  and 192; three (lo.hi + hi.lo + hi.hi) pass it.
- At inputs x8 (scores x64) no f32 evaluation meets the gate against
  another: the f64 value itself misses `attention_plain` by tens of times.
  There chip_smoke holds the kernel to be no further from the f64 value
  than `attention_plain` is, which three passes are and one is not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

GATE = dict(rtol=1e-5, atol=1e-5)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x to TF32, to nearest with ties away: (bits + 0x1000) & ~0x1fff."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] in k-steps of 8, as the tensor-core
    kernel: each step's products summed exactly, rounded to f32 once and
    added to an f32 sum."""
    a_hi, b_hi = _tf32_round(a), _tf32_round(b)
    a_lo, b_lo = _tf32_read(a - a_hi), _tf32_read(b - b_hi)
    terms = ([(a_hi, b_hi)] if passes == 1
             else [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)])
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        step = sum(x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
                   for x, y in terms)
        out = out + step.float()
    return out


def _attention_tf32(q, k, v, causal, window, passes):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(hq // hkv, dim=1)
    vf = v.repeat_interleave(hq // hkv, dim=1)
    scores = _matmul(q * (1.0 / d ** 0.5), kf.transpose(-1, -2), passes)
    q_pos = torch.arange(sq) + (skv - sq)
    k_pos = torch.arange(skv)
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return _matmul(probs, vf, passes)


def _attention_f64(q, k, v):
    """Causal attention evaluated in float64, q, k and v of one shape."""
    s = (q.double() / q.shape[-1] ** 0.5) @ k.double().transpose(-1, -2)
    mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v.double()


def _gate_share(got, want) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 passes."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max())


def _inputs(q_shape, kv_shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(scale * rng.standard_normal(s).astype(np.float32))
            for s in (q_shape, kv_shape, kv_shape)]


def test_tf32_round_is_round_to_nearest_ties_away():
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10 (TF32's ulp at 1)
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -11 - 2.0 ** -20,
                      0.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10, 1.0, 0.0]
    assert _tf32_round(x).tolist() == want
    assert _tf32_read(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0


@pytest.mark.parametrize("d", [96, 128, 192])
@pytest.mark.parametrize("q_shape,kv_shape,causal,window", [
    ((2, 8, 64, None), (2, 8, 64, None), True, None),     # MLA's shape, cut
    ((2, 6, 70, None), (2, 2, 130, None), True, 40),      # GQA, window
    ((3, 4, 33, None), (3, 4, 33, None), False, None),    # non-causal
])
def test_gate_fails_one_tf32_pass_and_passes_three(d, q_shape, kv_shape,
                                                   causal, window):
    q, k, v = _inputs(q_shape[:3] + (d,), kv_shape[:3] + (d,), seed=d)
    want = fa.attention_plain(q, k, v, causal, window)
    three = _attention_tf32(q, k, v, causal, window, passes=3)
    one = _attention_tf32(q, k, v, causal, window, passes=1)
    assert torch.allclose(three, want, **GATE), _gate_share(three, want)
    assert not torch.allclose(one, want, **GATE)
    assert _gate_share(one, want) > 10.0


@pytest.mark.parametrize("d", [96, 128, 192])
def test_large_scores_are_held_to_the_f64_value(d):
    """Inputs x8: the f64 value misses attention_plain's gate, so no
    f32 evaluation can be held to it; three passes stay no further from
    the f64 value than attention_plain, one pass hundreds of times
    further."""
    q, k, v = _inputs((2, 8, 64, d), (2, 8, 64, d), seed=d + 1, scale=8.0)
    plain = fa.attention_plain(q, k, v)
    exact = _attention_f64(q, k, v)
    assert _gate_share(exact, plain) > 10.0
    three = _attention_tf32(q, k, v, True, None, passes=3)
    one = _attention_tf32(q, k, v, True, None, passes=1)
    assert _gate_share(three, exact) <= _gate_share(plain, exact)
    assert _gate_share(one, exact) > 100.0 * _gate_share(plain, exact)
