"""Empirical DP audit: a Clopper–Pearson ε̂ lower bound per run, ported
from `repro.privacy.audit`.

The audit plays the membership game against the mechanism as executed: a
canary client sends the worst-case payload the clip admits
(`Transport.canary_payload`) or stays silent; both arms of each paired
trace go through the transport's own `observe` under the run's schedule
with the same noise; the schedule-aware Gaussian LLR summed over the
horizon is one statistic a trial; Clopper–Pearson upper bounds on the
false-positive and false-negative rates (thresholds Bonferroni-corrected)
give

    ε̂ = max_τ max( log((1 − δ − β̄(τ)) / ᾱ(τ)),
                    log((1 − δ − ᾱ(τ)) / β̄(τ)) ),

a valid ε lower bound, held under the accountant's analytic ε
(`dp.epsilon_for_budget`). The paired traces run on the device, all
trials × rounds at once: cell (i, t) draws the mechanism's rows from the
reference's key fold_in(fold_in(key(seed), i), t) (`repro_torch.prng`).
The binomial tails are host float64, as the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import dp as dp_mod
from repro_torch.core import transport as tp


def _log_comb(n: int, k: int) -> np.ndarray:
    """[k+1] log C(n, i) for i = 0..k from one log-factorial table."""
    logfact = np.concatenate(
        ([0.0], np.cumsum(np.log(np.arange(1, n + 1, dtype=np.float64)))))
    i = np.arange(k + 1)
    return logfact[n] - logfact[i] - logfact[n - i]


def binom_logcdf(k: int, n: int, p: float) -> float:
    """log P[Bin(n, p) ≤ k], exact via log-pmf + logsumexp."""
    if k >= n or p <= 0.0:
        return 0.0
    if p >= 1.0:
        return -math.inf
    i = np.arange(k + 1, dtype=np.float64)
    logpmf = _log_comb(n, k) + i * math.log(p) + (n - i) * math.log1p(-p)
    m = logpmf.max()
    return float(m + np.log(np.sum(np.exp(logpmf - m))))


def clopper_pearson_upper(k: int, n: int, confidence: float = 0.95) -> float:
    """Exact upper confidence bound on a binomial proportion: the largest p
    still consistent with ≤ k successes in n trials (60 bisection steps)."""
    if n <= 0:
        return 1.0
    if k >= n:
        return 1.0
    log_alpha = math.log(1.0 - confidence)
    logcomb = _log_comb(n, k)
    i = np.arange(k + 1, dtype=np.float64)

    def logcdf(p: float) -> float:
        logpmf = logcomb + i * math.log(p) + (n - i) * math.log1p(-p)
        m = logpmf.max()
        return float(m + np.log(np.sum(np.exp(logpmf - m))))

    lo, hi = k / n, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if logcdf(mid) > log_alpha:
            lo = mid
        else:
            hi = mid
    return hi


@dataclass(frozen=True)
class AuditResult:
    """One audited run: the empirical bound against the analytic one."""
    eps_hat: float
    eps_analytic: float
    spent: float
    delta: float
    trials: int
    confidence: float
    rounds: int
    fpr: float = 0.0
    fnr: float = 0.0
    threshold: float = 0.0
    meta: dict = field(default_factory=dict)

    @property
    def dominated(self) -> bool:
        """The contract: the empirical ε̂ never exceeds the analytic ε."""
        return self.eps_hat <= self.eps_analytic + 1e-9

    def to_dict(self) -> dict:
        return {"eps_hat": self.eps_hat, "eps_analytic": self.eps_analytic,
                "spent": self.spent, "delta": self.delta,
                "trials": self.trials, "confidence": self.confidence,
                "rounds": self.rounds, "fpr": self.fpr, "fnr": self.fnr,
                "dominated": self.dominated, **self.meta}


def _eps_from_rates(fp: int, fn: int, n: int, delta: float,
                    confidence: float) -> tuple:
    """(ε̂, ᾱ, β̄) at one threshold from raw FP/FN counts."""
    a_hi = clopper_pearson_upper(fp, n, confidence)
    b_hi = clopper_pearson_upper(fn, n, confidence)
    best = 0.0
    for num, den in ((1.0 - delta - b_hi, a_hi),
                     (1.0 - delta - a_hi, b_hi)):
        if num > 0.0 and den > 0.0 and num > den:
            best = max(best, math.log(num / den))
    return best, a_hi, b_hi


def paired_trace_statistics(transport, schedule, canary: float, *,
                            rounds: int, n_clients: int, trials: int,
                            seed: int = 0xA0D17,
                            device="cuda") -> tuple:
    """(stat_in [trials], stat_out [trials]) f64: the LLR statistics of
    paired canary-in / canary-out traces through the transport's own
    `observe`, all trials × rounds in one batch on `device`. Cell (i, t)
    reads the draw rows of key fold_in(fold_in(key(seed), i), t) for both
    arms; rounds with c = 0 carry no signal."""
    if "y" not in transport.observation_spec(n_clients):
        raise ValueError(
            f"transport {transport.name!r} exposes no scalar 'y' "
            "observation stream — the paired-trace audit needs one "
            "(override Transport.observe/observation_spec)")
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    c = torch.tensor(np.asarray(schedule.c[:rounds], np.float32), **f32)
    sigma = torch.tensor(np.asarray(schedule.sigma[:rounds], np.float32),
                         **f32)
    n0 = torch.tensor(np.float32(schedule.n0), **f32)
    p_in = torch.zeros(n_clients, **f32)
    p_in[0] = float(np.float32(canary))
    p_out = torch.zeros(n_clients, **f32)
    # known-schedule LLR weights: shift s_t = c_t·canary, noise var m_t²
    s = c * float(np.float32(canary))
    m2 = c * c * torch.sum(sigma * sigma, dim=1) + n0
    active = (c > 0).to(torch.float32)
    keys = prng.fold_in(
        prng.fold_in(prng.key(seed, dev), torch.arange(trials, device=dev)
                     )[:, None, :],
        torch.arange(c.shape[0], device=dev))             # [trials, R, 2]
    ctl = {"c": c, "sigma": sigma, "n0": n0,
           "mask": torch.ones(n_clients, **f32)}
    ctl.update(tp.key_draws(transport.draws, keys, n_clients))
    y_in = transport.observe(p_in, ctl)["y"]              # [trials, R]
    y_out = transport.observe(p_out, ctl)["y"]

    def llr(y):
        return active * (s * (y - 0.5 * s) / m2)

    stat_in = torch.sum(llr(y_in), dim=-1)
    stat_out = torch.sum(llr(y_out), dim=-1)
    return (stat_in.cpu().numpy().astype(np.float64),
            stat_out.cpu().numpy().astype(np.float64))


def audit_transport(transport, schedule, pz, *, rounds: Optional[int] = None,
                    trials: int = 2000, confidence: float = 0.95,
                    thresholds: int = 9, seed: int = 0xA0D17,
                    spent: Optional[float] = None,
                    device="cuda") -> AuditResult:
    """Audit one (transport, realized schedule) pair: ε̂ against the
    analytic ε over `rounds` executed rounds. `spent` feeds the analytic
    side from a run's own ledger (`RunResult.privacy_spent`); None sums
    the transport's DP costs over the rounds. The paired traces run on
    `device`."""
    rounds = int(schedule.c.shape[0] if rounds is None else rounds)
    canary = transport.canary_payload(pz)
    delta = pz.dp.delta
    if spent is None:
        charged = transport.charges_privacy(schedule, pz)
        spent = float(np.sum(
            transport.round_dp_costs(schedule, 0, rounds, pz))) \
            if charged else 0.0
    else:
        spent = float(spent)
    if canary is None:
        # no DP mechanism: ε̂ = ∞ is the honest verdict for an uplink that
        # exposes payloads exactly
        return AuditResult(eps_hat=math.inf, eps_analytic=math.inf,
                           spent=spent, delta=delta, trials=0,
                           confidence=confidence, rounds=rounds,
                           meta={"transport": transport.name,
                                 "auditable": False})

    stat_in, stat_out = paired_trace_statistics(
        transport, schedule, canary, rounds=rounds,
        n_clients=pz.n_clients, trials=trials, seed=seed, device=device)

    # the Bayes point 0 and pooled quantiles; two bounds a threshold
    pooled = np.concatenate([stat_in, stat_out])
    grid = np.unique(np.concatenate(
        [[0.0], np.quantile(pooled, np.linspace(0.05, 0.95, thresholds))]))
    conf_each = 1.0 - (1.0 - confidence) / (2 * len(grid))

    best = (0.0, 0.0, 0.0, 0.0)     # (eps, tau, fpr, fnr)
    n = trials
    for tau in grid:
        fp = int(np.sum(stat_out > tau))     # out, flagged in
        fn = int(np.sum(stat_in <= tau))     # in, flagged out
        eps, a_hi, b_hi = _eps_from_rates(fp, fn, n, delta, conf_each)
        if eps > best[0]:
            best = (eps, float(tau), a_hi, b_hi)

    return AuditResult(
        eps_hat=best[0],
        eps_analytic=dp_mod.epsilon_for_budget(spent, delta),
        spent=spent, delta=delta, trials=trials, confidence=confidence,
        rounds=rounds, fpr=best[2], fnr=best[3], threshold=best[1],
        meta={"transport": transport.name, "auditable": True,
              "canary": canary})
