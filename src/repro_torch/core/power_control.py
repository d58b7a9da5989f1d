"""Power control for analog and Sign-pAirZero (paper Sec. VI, Theorems 3
and 4), copied from `repro.core.power_control`: the `solution` schedules,
the Static and Reversed baselines, the `make_schedule` dispatcher,
`transmit_power` and `defended_config` (a transmit clip folded into the
solve).

Host-side numpy: the schedule is a base-station decision made between
rounds. Both theorems give σ_k* = 0, so every solver returns the c⁽ᵗ⁾
schedule with σ ≡ 0. A c(t) of 0 is a silent round.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.dp import r_dp


def defended_config(pz, clip: float):
    """The run config with `zo.clip_gamma = min(γ, γ_d)`: a PHY clip at
    ±γ_d tightens Assumption 3's payload bound, which enters both the
    power-cap min and the Lemma-1 sensitivity of the Theorem-3/4 solve
    (and the audit's canary). Unchanged when γ_d ≥ γ."""
    g = min(float(pz.zo.clip_gamma), float(clip))
    if g == float(pz.zo.clip_gamma):
        return pz
    return dataclasses.replace(
        pz, zo=dataclasses.replace(pz.zo, clip_gamma=g))


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


def static_analog(h: np.ndarray, *, power: float, n0: float, gamma: float,
                  epsilon: float, delta: float) -> PowerSchedule:
    """Static baseline (Eq. 40): even privacy spend, c(t) constant."""
    h = np.asarray(h, dtype=np.float64)
    T, K = h.shape
    gam = np.full(T, float(gamma))
    budget = r_dp(epsilon, delta)
    c_static = math.sqrt(n0 * budget / (2.0 * T * gamma * gamma))
    c_cap = _analog_full_power_c(h, power, gam)
    return PowerSchedule(c=np.minimum(c_static, c_cap),
                         sigma=np.zeros((T, K)), scheme="static", n0=n0)


def reversed_analog(h: np.ndarray, *, power: float, n0: float, gamma: float,
                    contraction_a: float, epsilon: float, delta: float,
                    bisect_tol: float = 1e-12,
                    bisect_iters: int = 200) -> PowerSchedule:
    """Reversed baseline: A^{-t/4} → A^{+t/4} (decreasing gain trend)."""
    h = np.asarray(h, dtype=np.float64)
    T, K = h.shape
    gam = np.full(T, float(gamma))
    budget = r_dp(epsilon, delta)
    c_cap = _analog_full_power_c(h, power, gam)
    a = float(contraction_a)
    t_idx = np.arange(1, T + 1, dtype=np.float64)

    def c_of_zeta(zeta: float) -> np.ndarray:
        adaptive = (a ** (+t_idx / 4.0)) * math.sqrt(n0) \
            / ((2.0 * zeta) ** 0.25 * np.sqrt(gam))
        return np.minimum(adaptive, c_cap)

    def spent(zeta: float) -> float:
        c = c_of_zeta(zeta)
        return float(np.sum(2.0 * gam ** 2 * c ** 2 / n0))

    if float(np.sum(2.0 * gam ** 2 * c_cap ** 2 / n0)) <= budget:
        return PowerSchedule(c=c_cap, sigma=np.zeros((T, K)),
                             scheme="reversed", n0=n0)
    lo, hi = 0.0, 1.0
    while spent(hi) > budget:
        hi *= 4.0
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        if spent(mid) > budget:
            lo = mid
        else:
            hi = mid
        if hi - lo <= bisect_tol * max(hi, 1.0):
            break
    return PowerSchedule(c=c_of_zeta(hi), sigma=np.zeros((T, K)),
                         scheme="reversed", zeta=hi, n0=n0)


# ---------------------------------------------------------------------------
# Sign-pAirZero — Theorem 4 (γ ≡ 1)
# ---------------------------------------------------------------------------

def _sign_b_constants(n_clients: int, e0: float) -> tuple:
    """B1, B2 of Lemma 2 / Eq. (67) (Lemma-2-consistent squared form)."""
    b1 = n_clients ** 2 * (1.0 - 2.0 * e0) ** 2
    b2 = 4.0 * n_clients * e0 * (1.0 - e0)
    return b1, b2


def solve_sign(h: np.ndarray, *, power: float, n0: float, n_clients: int,
               e0: float, contraction_a_tilde: float, epsilon: float,
               delta: float, bisect_tol: float = 1e-12,
               bisect_iters: int = 200) -> PowerSchedule:
    """Theorem 4: closed-form c(t) schedule for Sign-pAirZero.

    Internally solves in the substituted variable m(t) = Σσ² + N0/c² (the
    post-inversion noise-to-gain measure of Appendix E); with σ* = 0 the
    transmit gain is c(t) = √(N0 / m(t)).
    """
    h = np.asarray(h, dtype=np.float64)
    T, K = h.shape
    budget = r_dp(epsilon, delta)
    b1, b2 = _sign_b_constants(n_clients, e0)
    at = float(contraction_a_tilde)
    t_idx = np.arange(1, T + 1, dtype=np.float64)
    # full-power floor on m (Eq. 84 taken over all clients)
    m_floor = n0 / (power * np.min(h, axis=1) ** 2)

    # full-power privacy cost: Σ_t 2 / m_floor
    if float(np.sum(2.0 / m_floor)) <= budget:
        c = np.sqrt(n0 / m_floor)
        return PowerSchedule(c=c, sigma=np.zeros((T, K)), scheme="solution",
                             zeta=0.0, n0=n0)

    def m_of_zeta(zeta: float) -> np.ndarray:
        # positive root of the KKT quadratic (Eq. 86); ∞ once Ã^{-t}B2² ≤ 2ζ
        disc = at ** (-t_idx) * b2 * b2 - 2.0 * zeta
        with np.errstate(divide="ignore", invalid="ignore"):
            m_formula = np.where(
                disc > 0.0,
                (b1 + b2) * (4.0 * zeta
                             + np.sqrt(8.0 * at ** (-t_idx) * b2 * b2 * zeta))
                / (2.0 * disc),
                np.inf)
        return np.maximum(m_floor, m_formula)

    def spent(zeta: float) -> float:
        return float(np.sum(2.0 / m_of_zeta(zeta)))

    lo, hi = 0.0, 1.0
    while spent(hi) > budget:
        hi *= 4.0
        if hi > 1e30:  # pragma: no cover
            raise RuntimeError("sign power-control bisection failed")
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        if spent(mid) > budget:
            lo = mid
        else:
            hi = mid
        if hi - lo <= bisect_tol * max(hi, 1.0):
            break
    zeta = hi
    m = m_of_zeta(zeta)
    c = np.where(np.isfinite(m), np.sqrt(n0 / m), 0.0)
    return PowerSchedule(c=c, sigma=np.zeros((T, K)), scheme="solution",
                         zeta=zeta, n0=n0)


def static_sign(h: np.ndarray, *, power: float, n0: float,
                epsilon: float, delta: float) -> PowerSchedule:
    h = np.asarray(h, dtype=np.float64)
    T, K = h.shape
    budget = r_dp(epsilon, delta)
    c_static = math.sqrt(n0 * budget / (2.0 * T))
    c_cap = np.min(math.sqrt(power) * h, axis=1)
    return PowerSchedule(c=np.minimum(c_static, c_cap),
                         sigma=np.zeros((T, K)), scheme="static", n0=n0)


def reversed_sign(h: np.ndarray, *, power: float, n0: float, n_clients: int,
                  e0: float, contraction_a_tilde: float, epsilon: float,
                  delta: float, bisect_tol: float = 1e-12,
                  bisect_iters: int = 200) -> PowerSchedule:
    """Reversed baseline for sign: Ã^{-t} → Ã^{+t} in the adaptive term."""
    h = np.asarray(h, dtype=np.float64)
    T, K = h.shape
    budget = r_dp(epsilon, delta)
    b1, b2 = _sign_b_constants(n_clients, e0)
    at = float(contraction_a_tilde)
    t_idx = np.arange(1, T + 1, dtype=np.float64)
    m_floor = n0 / (power * np.min(h, axis=1) ** 2)
    if float(np.sum(2.0 / m_floor)) <= budget:
        c = np.sqrt(n0 / m_floor)
        return PowerSchedule(c=c, sigma=np.zeros((T, K)), scheme="reversed",
                             n0=n0)

    def m_of_zeta(zeta: float) -> np.ndarray:
        disc = at ** (+t_idx) * b2 * b2 - 2.0 * zeta
        with np.errstate(divide="ignore", invalid="ignore"):
            m_formula = np.where(
                disc > 0.0,
                (b1 + b2) * (4.0 * zeta
                             + np.sqrt(8.0 * at ** (+t_idx) * b2 * b2 * zeta))
                / (2.0 * disc),
                np.inf)
        return np.maximum(m_floor, m_formula)

    def spent(zeta: float) -> float:
        return float(np.sum(2.0 / m_of_zeta(zeta)))

    lo, hi = 0.0, 1.0
    while spent(hi) > budget:
        hi *= 4.0
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        if spent(mid) > budget:
            lo = mid
        else:
            hi = mid
        if hi - lo <= bisect_tol * max(hi, 1.0):
            break
    m = m_of_zeta(hi)
    c = np.where(np.isfinite(m), np.sqrt(n0 / m), 0.0)
    return PowerSchedule(c=c, sigma=np.zeros((T, K)), scheme="reversed",
                         zeta=hi, n0=n0)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def make_schedule(variant: str, scheme: str, h: np.ndarray, *, power: float,
                  n0: float, gamma: float, n_clients: int, e0: float,
                  contraction_a: float, contraction_a_tilde: float,
                  epsilon: float, delta: float) -> PowerSchedule:
    """Build a T-round schedule for (variant ∈ {analog, sign}) × scheme;
    the OTA transports' `make_schedule` calls this with their config's
    values."""
    if scheme == "perfect":
        T, K = np.asarray(h).shape
        return PowerSchedule(c=np.ones(T), sigma=np.zeros((T, K)),
                             scheme="perfect", n0=0.0)
    if variant == "analog":
        if scheme == "solution":
            return solve_analog(h, power=power, n0=n0, gamma=gamma,
                                contraction_a=contraction_a,
                                epsilon=epsilon, delta=delta)
        if scheme == "static":
            return static_analog(h, power=power, n0=n0, gamma=gamma,
                                 epsilon=epsilon, delta=delta)
        if scheme == "reversed":
            return reversed_analog(h, power=power, n0=n0, gamma=gamma,
                                   contraction_a=contraction_a,
                                   epsilon=epsilon, delta=delta)
    elif variant == "sign":
        if scheme == "solution":
            return solve_sign(h, power=power, n0=n0, n_clients=n_clients,
                              e0=e0, contraction_a_tilde=contraction_a_tilde,
                              epsilon=epsilon, delta=delta)
        if scheme == "static":
            return static_sign(h, power=power, n0=n0, epsilon=epsilon,
                               delta=delta)
        if scheme == "reversed":
            return reversed_sign(h, power=power, n0=n0, n_clients=n_clients,
                                 e0=e0, contraction_a_tilde=contraction_a_tilde,
                                 epsilon=epsilon, delta=delta)
    raise ValueError(f"unknown variant/scheme: {variant}/{scheme}")


def transmit_power(schedule: PowerSchedule, h: np.ndarray, gamma: float,
                   d: int) -> np.ndarray:
    """Per-(t,k) transmit power (c/h_k)²(γ² + d σ_k²) — LHS of (C2)/(C4)."""
    h = np.asarray(h, dtype=np.float64)
    c = schedule.c[:, None]
    return (c / h) ** 2 * (gamma ** 2 + d * schedule.sigma ** 2)
