"""Differential-privacy accountant (paper Sec. IV-C, Lemma 1), copied from
`repro.core.dp`. Host-side float64, bitwise equal to the reference.

    Σ_t ( √2 · c⁽ᵗ⁾ γ⁽ᵗ⁾ / m⁽ᵗ⁾ )²  ≤  R_dp(ε, δ)              (Eq. 16)
    R_dp(ε, δ) = ( √(ε + [C⁻¹(1/δ)]²) − C⁻¹(1/δ) )²            (Eq. 17)
    C(x)       = √π · x · e^{x²}

The ledger is a strictly sequential float64 left fold (`np.cumsum`), never
`sum()`: Python's `sum` is compensated and would move the last bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np


def log_c_func(x: float) -> float:
    """log C(x) — overflow-safe."""
    if x <= 0:
        return -math.inf
    return 0.5 * math.log(math.pi) + math.log(x) + x * x


def c_inverse(y: float, tol: float = 1e-14, max_iter: int = 400) -> float:
    """C⁻¹(y) for y > 0 by bisection on log C(x) (monotone increasing)."""
    if y <= 0:
        raise ValueError("C^{-1} defined for y > 0")
    log_y = math.log(y)
    lo, hi = 0.0, 1.0
    while log_c_func(hi) < log_y:
        hi *= 2.0
        if hi > 1e8:  # pragma: no cover - unreachable for sane δ
            break
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if log_c_func(mid) < log_y:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


def r_dp(epsilon: float, delta: float) -> float:
    """Privacy budget radius R_dp(ε, δ) of Eq. (17)."""
    if epsilon <= 0:
        raise ValueError("epsilon must be > 0")
    if not (0 < delta < 1):
        raise ValueError("delta must be in (0, 1)")
    cinv = c_inverse(1.0 / delta)
    return (math.sqrt(epsilon + cinv * cinv) - cinv) ** 2


def epsilon_for_budget(spent: float, delta: float) -> float:
    """The analytic ε of a spent Eq.-16 sum: R_dp(ε, δ) = (√(ε + c²) −
    c)² with c = C⁻¹(1/δ) inverts to ε = R + 2c√R (the ceiling the
    audit's ε̂ is held under, `repro_torch.privacy.audit`)."""
    if spent < 0:
        raise ValueError("spent budget must be >= 0")
    if not (0 < delta < 1):
        raise ValueError("delta must be in (0, 1)")
    if spent == 0.0:
        return 0.0
    cinv = c_inverse(1.0 / delta)
    return spent + 2.0 * cinv * math.sqrt(spent)


def round_privacy_cost(c_t: float, gamma_t: float, m_t: float) -> float:
    """Per-round term (√2 c γ / m)² of the accountant sum (Eq. 16)."""
    if m_t <= 0:
        raise ValueError("effective noise m must be > 0")
    return 2.0 * (c_t * gamma_t / m_t) ** 2


def cumulative_spend(costs, initial: float = 0.0) -> np.ndarray:
    """[R] ledger value after charging each of `costs` in order (the same
    sequential float64 fold `PrivacyAccountant.spend_batch` performs)."""
    costs = np.asarray(costs, dtype=np.float64)
    if costs.size == 0:
        return np.zeros(0, dtype=np.float64)
    return np.cumsum(np.concatenate(([float(initial)], costs)))[1:]


@dataclass
class PrivacyAccountant:
    """Tracks spent DP budget across rounds."""
    epsilon: float
    delta: float
    spent: float = 0.0
    history: List[float] = field(default_factory=list)

    @property
    def budget(self) -> float:
        return r_dp(self.epsilon, self.delta)

    def spend_batch(self, costs) -> float:
        """Charge a chunk of per-round costs with the sequential left fold;
        returns the total charged."""
        costs = np.asarray(costs, dtype=np.float64)
        if costs.size == 0:
            return 0.0
        before = self.spent
        self.spent = float(np.cumsum(np.concatenate(([before], costs)))[-1])
        self.history.extend(float(c) for c in costs)
        return self.spent - before

    # -- checkpoint (de)serialization: the reference's keys ----------------
    def state_dict(self) -> dict:
        return {"epsilon": self.epsilon, "delta": self.delta,
                "spent": self.spent}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PrivacyAccountant":
        return cls(epsilon=float(d["epsilon"]), delta=float(d["delta"]),
                   spent=float(d["spent"]))
