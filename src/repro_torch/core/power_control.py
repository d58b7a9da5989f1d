"""Theorem-3 power control for analog pAirZero (paper Sec. VI), copied from
`repro.core.power_control` (the `solution` scheme; the static/reversed
baselines and the sign variant are not ported yet).

Host-side numpy: the schedule is a base-station decision made between
rounds. σ_k* = 0, so the solver returns the c⁽ᵗ⁾ schedule with σ ≡ 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.dp import r_dp


@dataclass
class PowerSchedule:
    """Per-round transmit plan for T rounds and K clients."""
    c: np.ndarray             # [T] effective channel gain c(t)
    sigma: np.ndarray         # [T, K] artificial-noise std
    scheme: str
    zeta: float = 0.0         # Lagrange multiplier (0 ⇒ full power feasible)
    n0: float = 1.0


def _analog_full_power_c(h: np.ndarray, power: float,
                         gamma: np.ndarray) -> np.ndarray:
    """Power-cap gain per round: c_cap(t) = min_k √P h_k(t) / γ_k(t)."""
    return np.min(math.sqrt(power) * h / gamma[:, None], axis=1)


def solve_analog(h: np.ndarray, *, power: float, n0: float, gamma: float,
                 contraction_a: float, epsilon: float, delta: float,
                 bisect_tol: float = 1e-12,
                 bisect_iters: int = 200) -> PowerSchedule:
    """Theorem 3: closed-form c(t) schedule for analog pAirZero.

    h: [T, K] per-round per-client channel magnitudes; gamma: the
    projection clip bound γ."""
    h = np.asarray(h, dtype=np.float64)
    T, K = h.shape
    gam = np.full(T, float(gamma))
    budget = r_dp(epsilon, delta)
    c_cap = _analog_full_power_c(h, power, gam)
    a = float(contraction_a)

    # privacy cost at full power (σ = 0 ⇒ m² = N0): Σ_t 2 γ² c_cap² / N0
    cap_cost_t = 2.0 * gam ** 2 * c_cap ** 2 / n0
    if float(np.sum(cap_cost_t)) <= budget:
        # Condition (28): full power forever stays inside the budget.
        return PowerSchedule(c=c_cap, sigma=np.zeros((T, K)),
                             scheme="solution", zeta=0.0, n0=n0)

    t_idx = np.arange(1, T + 1, dtype=np.float64)

    def c_of_zeta(zeta: float) -> np.ndarray:
        # adaptive term of Eq. (30): A^{-t/4} N0^{1/2} (2ζ)^{-1/4} γ^{-1/2}
        adaptive = (a ** (-t_idx / 4.0)) * math.sqrt(n0) \
            / ((2.0 * zeta) ** 0.25 * np.sqrt(gam))
        return np.minimum(adaptive, c_cap)

    def spent(zeta: float) -> float:
        c = c_of_zeta(zeta)
        return float(np.sum(2.0 * gam ** 2 * c ** 2 / n0))

    # bracket ζ: spent() is strictly decreasing in ζ
    lo, hi = 0.0, 1.0
    while spent(hi) > budget:
        hi *= 4.0
        if hi > 1e30:  # pragma: no cover
            raise RuntimeError("power-control bisection failed to bracket")
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        if spent(mid) > budget:
            lo = mid
        else:
            hi = mid
        if hi - lo <= bisect_tol * max(hi, 1.0):
            break
    zeta = hi  # feasible side
    return PowerSchedule(c=c_of_zeta(zeta), sigma=np.zeros((T, K)),
                         scheme="solution", zeta=zeta, n0=n0)
