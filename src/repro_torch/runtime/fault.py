"""Client dropout, stragglers and elastic membership, copied from
`repro.runtime.fault` (host numpy, bitwise equal to the reference).

A failed or late client does not superpose its signal: the server sees the
surviving set (the survival mask) and inverts by K_eff. A rejoining client
needs only (w, t, seed).

`FaultModel` draws from one `np.random.default_rng(seed)` in call order,
whatever round it is asked about, exactly as the reference does. So two
runs that ask for the same rounds in the same order get the same masks,
but a run resumed at round s builds a fresh model and draws its first row
at s: with faults on, its tail differs from the uninterrupted run's, in
the reference as here (ROADMAP, findings of the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class FaultModel:
    """Per-round client availability.

    dropout_p:    iid probability a client's uplink fails this round.
    straggler_p:  probability a client misses the OTA deadline this round.
    mtbf_rounds:  if set, clients also fail "hard" (mean time between
                  failures, exponential) and rejoin after `repair_rounds`.
    """
    n_clients: int
    dropout_p: float = 0.0
    straggler_p: float = 0.0
    mtbf_rounds: Optional[float] = None
    repair_rounds: int = 10
    seed: int = 0

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        for name in ("dropout_p", "straggler_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.dropout_p + self.straggler_p > 1.0:
            raise ValueError(
                f"dropout_p + straggler_p must be <= 1 (the per-round "
                f"keep-probability 1 - dropout_p - straggler_p would be "
                f"negative), got {self.dropout_p} + {self.straggler_p} = "
                f"{self.dropout_p + self.straggler_p}")
        self._rng = np.random.default_rng(self.seed)
        self._down_until = np.zeros(self.n_clients, dtype=np.int64)

    def survival_mask(self, t: int) -> np.ndarray:
        """[K] 0/1 mask of the clients whose signal superposes in round t
        (never all zero)."""
        up = self._down_until <= t
        if self.mtbf_rounds:
            fails = self._rng.random(self.n_clients) < 1.0 / self.mtbf_rounds
            newly_down = up & fails
            self._down_until[newly_down] = t + self.repair_rounds
            up = self._down_until <= t
        transient = (self._rng.random(self.n_clients)
                     >= self.dropout_p + self.straggler_p)
        mask = (up & transient).astype(np.float32)
        if mask.sum() == 0:
            mask[self._rng.integers(self.n_clients)] = 1.0
        return mask


@dataclass
class ElasticSchedule:
    """Planned membership: `events` is a sequence of (round, K_new); the
    mask activates the first K(t) client slots."""
    n_clients: int
    events: tuple = ()

    def active_k(self, t: int) -> int:
        """Planned number of active clients in round t (last event wins)."""
        k = self.n_clients
        for round_t, k_new in sorted(self.events):
            if t >= round_t:
                k = k_new
        return max(1, min(k, self.n_clients))

    def membership_mask(self, t: int) -> np.ndarray:
        """[K] 0/1 mask activating the first active_k(t) client slots."""
        mask = np.zeros(self.n_clients, dtype=np.float32)
        mask[: self.active_k(t)] = 1.0
        return mask


def combined_mask(t: int, fault: Optional[FaultModel] = None,
                  elastic: Optional[ElasticSchedule] = None,
                  n_clients: Optional[int] = None) -> np.ndarray:
    """[K] survival ∧ membership mask for round t (never all zero). With
    neither model, `n_clients` sizes the all-ones mask."""
    if fault is None and elastic is None:
        if n_clients is None:
            raise ValueError(
                "combined_mask: n_clients is required when neither a "
                "FaultModel nor an ElasticSchedule is given")
        return np.ones(n_clients, dtype=np.float32)
    mask = None
    if elastic is not None:
        mask = elastic.membership_mask(t)
    if fault is not None:
        fm = fault.survival_mask(t)
        mask = fm if mask is None else mask * fm
    if mask.sum() == 0:
        mask[0] = 1.0
    return mask
