"""Rayleigh block fading, copied from `repro.channel.models`.

Host-side numpy with `np.random.default_rng(seed)`; the draw order (the
[T, K] real parts, then the [T, K] imaginary parts) is part of the
contract, so the trace is bitwise equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.channel.registry import ChannelModel, register
from repro_torch.channel.trace import ChannelTrace


@register("rayleigh")
@dataclass(frozen=True)
class RayleighFading(ChannelModel):
    """i.i.d. block fading, h ~ CN(0, 1): |h| Rayleigh, E[|h|²] = 1."""

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        rng = np.random.default_rng(seed)
        re = rng.normal(size=(rounds, n_clients)) / np.sqrt(2.0)
        im = rng.normal(size=(rounds, n_clients)) / np.sqrt(2.0)
        return ChannelTrace(h=np.sqrt(re * re + im * im),
                            meta={"model": self.name})
