"""Wrapper channel models: geometry, imperfect CSI, deep-fade outage,
copied from `repro.channel.wrappers`.

Each wrapper holds a `base` model, realizes its trace and changes one
physical aspect of it:

  PathLossGeometry  scales magnitudes by per-client large-scale gains from
                    a cell placement and log-distance path loss;
  ImperfectCSI      adds residual phase error to the pre-compensation;
  OutageModel       thresholds the instantaneous channel power into a
                    per-round participation mask.

Wrapper randomness uses seeds derived from the run seed with fixed XOR
tags, apart from the base draw, so wrapping never changes the base fading
realization.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.channel.models import RayleighFading
from repro_torch.channel.registry import ChannelModel, register
from repro_torch.channel.trace import ChannelTrace

# seed tags: keep wrapper streams apart from the base fading draw (which
# consumes the raw seed) and from each other
_GEOMETRY_TAG = 0x6E0
_CSI_TAG = 0xC51
_SHADOW_TAG = 0x5AD0


class _WrapperFromConfig:
    """Wrappers are registered but are not base models: selecting one as
    ChannelConfig.model would ignore its config fields and then wrap it
    twice, so that raises and names the config fields that compose it."""

    _select_via = "?"

    @classmethod
    def from_config(cls, cc) -> "ChannelModel":
        raise ValueError(
            f"channel model {cls.name!r} is a wrapper, not a base fading "
            f"model: pick a base (e.g. model='rayleigh') and set "
            f"{cls._select_via} to compose it (see "
            "repro_torch.channel.registry.from_config)")


@register("geometry")
@dataclass(frozen=True)
class PathLossGeometry(_WrapperFromConfig, ChannelModel):
    """Cell geometry + log-distance path loss over a base model.

    Clients are placed uniformly by area in the annulus [0.05·R, R] (one
    layout per run seed); the dB loss is pathloss_exp · 10 log10(d / d_ref)
    and the linear power gains are normalized to mean 1 across clients.
    `shadow_std_db` > 0 adds correlated log-normal shadowing
    X_k = σ (√ρ X₀ + √(1-ρ) ξ_k) from its own tagged stream; σ = 0 draws
    nothing from it."""
    _select_via = "cell_radius > 0"
    base: ChannelModel = field(default_factory=RayleighFading)
    cell_radius: float = 100.0      # meters
    pathloss_exp: float = 3.76      # 3GPP UMa-style NLOS exponent
    shadow_std_db: float = 0.0      # log-normal shadowing std (dB)
    shadow_corr: float = 0.5        # inter-client shadowing correlation

    def client_gains(self, seed: int, n_clients: int) -> np.ndarray:
        """[K] linear per-client power gains (mean 1 across the cell)."""
        if self.cell_radius <= 0.0:
            raise ValueError(f"cell_radius must be > 0, "
                             f"got {self.cell_radius}")
        rng = np.random.default_rng(seed ^ _GEOMETRY_TAG)
        r_min = 0.05 * self.cell_radius
        # uniform by area on the annulus [r_min, cell_radius]
        u = rng.random(n_clients)
        d = np.sqrt(u * (self.cell_radius ** 2 - r_min ** 2) + r_min ** 2)
        pl_db = 10.0 * self.pathloss_exp * np.log10(d / r_min)
        if self.shadow_std_db > 0.0:
            if not 0.0 <= self.shadow_corr <= 1.0:
                raise ValueError(f"shadow_corr must be in [0, 1], "
                                 f"got {self.shadow_corr}")
            srng = np.random.default_rng(seed ^ _SHADOW_TAG)
            common = srng.normal()
            own = srng.normal(size=n_clients)
            pl_db = pl_db + self.shadow_std_db * (
                np.sqrt(self.shadow_corr) * common
                + np.sqrt(1.0 - self.shadow_corr) * own)
        g = 10.0 ** (-pl_db / 10.0)
        return g / np.mean(g)

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        base = self.base.realize(seed, rounds, n_clients)
        g = self.client_gains(seed, n_clients)
        return ChannelTrace(h=base.h * np.sqrt(g)[None, :],
                            phase=base.phase,
                            participation=base.participation,
                            meta={**base.meta, "geometry": "pathloss",
                                  "cell_radius": self.cell_radius,
                                  "pathloss_exp": self.pathloss_exp,
                                  "shadow_std_db": self.shadow_std_db,
                                  "shadow_corr": self.shadow_corr,
                                  "client_gains": g})


@register("imperfect_csi")
@dataclass(frozen=True)
class ImperfectCSI(_WrapperFromConfig, ChannelModel):
    """Residual phase error θ_k(t) ~ N(0, phase_err_std²) in the OTA
    pre-compensation; magnitudes stay exact. phase_err_std = 0 draws θ ≡ 0
    exactly."""
    _select_via = "phase_err_std > 0"
    base: ChannelModel = field(default_factory=RayleighFading)
    phase_err_std: float = 0.1      # radians

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        if self.phase_err_std < 0.0:
            raise ValueError(f"phase_err_std must be >= 0, "
                             f"got {self.phase_err_std}")
        base = self.base.realize(seed, rounds, n_clients)
        rng = np.random.default_rng(seed ^ _CSI_TAG)
        theta = self.phase_err_std * rng.normal(size=base.h.shape)
        return ChannelTrace(h=base.h, phase=base.phase + theta,
                            participation=base.participation,
                            meta={**base.meta,
                                  "phase_err_std": self.phase_err_std})


@register("outage")
@dataclass(frozen=True)
class OutageModel(_WrapperFromConfig, ChannelModel):
    """Deep-fade outage: participation_k(t) = 1{|h_k(t)|² ≥ 10^(dB/10)}.
    A round in which every client fades out re-admits the strongest one,
    so the inversion by K_eff ≥ 1 stays meaningful."""
    _select_via = "outage_db"
    base: ChannelModel = field(default_factory=RayleighFading)
    threshold_db: float = -10.0

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        base = self.base.realize(seed, rounds, n_clients)
        tau = 10.0 ** (self.threshold_db / 10.0)
        up = (base.h ** 2 >= tau).astype(np.float32)
        participation = base.participation * up
        empty = participation.sum(axis=1) == 0
        if np.any(empty):
            rows = np.flatnonzero(empty)
            participation[rows, np.argmax(base.h[rows], axis=1)] = 1.0
        return ChannelTrace(h=base.h, phase=base.phase,
                            participation=participation,
                            meta={**base.meta,
                                  "outage_db": self.threshold_db})
