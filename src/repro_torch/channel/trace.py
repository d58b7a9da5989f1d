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
