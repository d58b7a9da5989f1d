"""ChannelTrace: one realized wireless channel for a training horizon
(copied from `repro.channel.trace`).

  h             [T, K] channel magnitudes |h_k(t)| (float64);
  phase         [T, K] residual CSI phase error θ (0 = perfect CSI);
  participation [T, K] 0/1 deep-fade outage mask (1 = transmits).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class ChannelTrace:
    """Realized channel for T rounds and K clients."""
    h: np.ndarray
    phase: np.ndarray = None
    participation: np.ndarray = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        h = np.asarray(self.h, dtype=np.float64)
        object.__setattr__(self, "h", h)
        if self.phase is None:
            object.__setattr__(self, "phase", np.zeros_like(h))
        if self.participation is None:
            object.__setattr__(
                self, "participation", np.ones(h.shape, dtype=np.float32))
        if self.phase.shape != h.shape or self.participation.shape != h.shape:
            raise ValueError(
                f"trace field shapes disagree: h{h.shape} "
                f"phase{self.phase.shape} "
                f"participation{self.participation.shape}")

    @property
    def rounds(self) -> int:
        return int(self.h.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.h.shape[1])

    @property
    def gain(self) -> np.ndarray:
        """[T, K] complex effective gains h·e^{jθ} after pre-compensation."""
        return self.h * np.exp(1j * self.phase)

    @property
    def csi(self) -> np.ndarray:
        """[T, K] per-client effective-gain factor cos θ (1.0 under perfect
        CSI)."""
        return np.cos(self.phase)

    def mean_power(self) -> np.ndarray:
        """[K] per-client mean channel power E_t[|h_k|²]."""
        return np.mean(self.h ** 2, axis=0)

    def outage_rate(self) -> float:
        """Fraction of (t, k) slots lost to deep fade."""
        return float(1.0 - np.mean(self.participation))
