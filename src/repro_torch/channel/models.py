"""Small-scale fading models: Rayleigh, Rician, Static, AR(1)-correlated,
copied from `repro.channel.models`.

Host-side numpy with `np.random.default_rng(seed)`. The draw order (the
[T, K] real parts, then the [T, K] imaginary parts, `_complex_normal_parts`)
is part of the contract: every model that generalizes Rayleigh reuses it,
so Rician K = 0 and AR(1) ρ = 0 are bitwise Rayleigh at the same seed, and
every trace is bitwise the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.channel.registry import ChannelModel, register
from repro_torch.channel.trace import ChannelTrace


def _complex_normal_parts(rng: np.random.Generator, rounds: int,
                          n_clients: int) -> tuple:
    """([T,K], [T,K]) re/im parts of CN(0, 1): per-component std 1/√2."""
    re = rng.normal(size=(rounds, n_clients)) / np.sqrt(2.0)
    im = rng.normal(size=(rounds, n_clients)) / np.sqrt(2.0)
    return re, im


def bessel_j0(x: float) -> float:
    """Bessel J₀(x) — Abramowitz & Stegun 9.4.1/9.4.3 rational
    approximations (|err| < 5e-8)."""
    ax = abs(float(x))
    if ax < 3.0:
        t = (ax / 3.0) ** 2
        return (1.0 + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
                + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100))))))
    t = 3.0 / ax
    f0 = (0.79788456 + t * (-0.00000077 + t * (-0.00552740
          + t * (-0.00009512 + t * (0.00137237 + t * (-0.00072805
          + t * 0.00014476))))))
    theta0 = (ax - 0.78539816 + t * (-0.04166397 + t * (-0.00003954
              + t * (0.00262573 + t * (-0.00054125 + t * (-0.00029333
              + t * 0.00013558))))))
    return f0 * math.cos(theta0) / math.sqrt(ax)


def jakes_rho(doppler_hz: float, round_duration_s: float) -> float:
    """Jakes'-spectrum lag-1 fading correlation ρ = J₀(2π f_D τ), clamped
    to [0, 1): past J₀'s first zero the stationary AR(1) surrogate cannot
    follow the negative autocorrelation, so fast mobility degenerates to
    i.i.d. block fading."""
    if doppler_hz < 0.0:
        raise ValueError(f"doppler_hz must be >= 0, got {doppler_hz}")
    if round_duration_s <= 0.0:
        raise ValueError(f"round_duration_s must be > 0, "
                         f"got {round_duration_s}")
    rho = bessel_j0(2.0 * math.pi * doppler_hz * round_duration_s)
    return float(min(max(rho, 0.0), 1.0 - 1e-9))


@register("rayleigh")
@dataclass(frozen=True)
class RayleighFading(ChannelModel):
    """i.i.d. block fading, h ~ CN(0, 1): |h| Rayleigh, E[|h|²] = 1."""

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        rng = np.random.default_rng(seed)
        re, im = _complex_normal_parts(rng, rounds, n_clients)
        return ChannelTrace(h=np.sqrt(re * re + im * im),
                            meta={"model": self.name})


@register("static")
@dataclass(frozen=True)
class StaticChannel(ChannelModel):
    """h ≡ 1: AWGN-only channel (the fading-free ablation)."""

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        return ChannelTrace(h=np.ones((rounds, n_clients)),
                            meta={"model": self.name})


@register("rician")
@dataclass(frozen=True)
class RicianFading(ChannelModel):
    """Rician block fading: a line-of-sight component of power K/(K+1) plus
    CN(0, 1/(K+1)) scatter, so E[|h|²] = 1 for every K-factor. K = 0 is
    Rayleigh bitwise (the LOS and scale factors are exactly 0.0 and 1.0)."""
    k_factor: float = 3.0

    @classmethod
    def from_config(cls, cc) -> "RicianFading":
        return cls(k_factor=float(cc.rician_k))

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        if self.k_factor < 0.0:
            raise ValueError(f"rician K-factor must be >= 0, "
                             f"got {self.k_factor}")
        rng = np.random.default_rng(seed)
        re, im = _complex_normal_parts(rng, rounds, n_clients)
        los = np.sqrt(self.k_factor / (self.k_factor + 1.0))
        scatter = np.sqrt(1.0 / (self.k_factor + 1.0))
        re = los + scatter * re
        im = scatter * im
        return ChannelTrace(h=np.sqrt(re * re + im * im),
                            meta={"model": self.name,
                                  "k_factor": self.k_factor})


@register("ar1")
@dataclass(frozen=True)
class AR1Correlated(ChannelModel):
    """Temporally correlated Rayleigh fading: per client the complex
    Gaussian follows x_0 = w_0, x_t = ρ x_{t-1} + √(1-ρ²) w_t with
    w_t ~ CN(0, 1), so E[|h|²] = 1 at every lag. ρ = 0 is Rayleigh bitwise."""
    rho: float = 0.9

    @classmethod
    def from_config(cls, cc) -> "AR1Correlated":
        # mobility given physically (doppler_hz + round duration) maps to ρ
        # through Jakes' J₀; unset keeps the raw ar1_rho knob
        if getattr(cc, "doppler_hz", None) is not None:
            return cls(rho=jakes_rho(cc.doppler_hz, cc.round_duration_s))
        return cls(rho=float(cc.ar1_rho))

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        if not 0.0 <= self.rho < 1.0:
            raise ValueError(f"ar1 rho must be in [0, 1), got {self.rho}")
        rng = np.random.default_rng(seed)
        re_w, im_w = _complex_normal_parts(rng, rounds, n_clients)
        rho = self.rho
        innov = np.sqrt(1.0 - rho * rho)
        re = np.empty_like(re_w)
        im = np.empty_like(im_w)
        re[0], im[0] = re_w[0], im_w[0]
        for t in range(1, rounds):
            re[t] = rho * re[t - 1] + innov * re_w[t]
            im[t] = rho * im[t - 1] + innov * im_w[t]
        return ChannelTrace(h=np.sqrt(re * re + im * im),
                            meta={"model": self.name, "rho": rho})
