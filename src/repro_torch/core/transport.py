"""Uplink mechanisms: the Transport protocol, ported from
`repro.core.transport` with the analog mechanism only.

A Transport owns (a) the device-side `aggregate(p_k, ctl) -> p̂`, (b) the
host-side schedule solve, (c) the per-round DP cost charged to the
accountant and (d) the uplink bits per round. The other mechanisms (sign,
perfect, digital, smart_digital, fo) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Type

import numpy as np
import torch

from repro_torch.core import ota
from repro_torch.core.dp import round_privacy_cost


@dataclass(frozen=True)
class Transport:
    """One uplink mechanism. Subclass + `@register(name)` to add one."""

    name = "?"

    @classmethod
    def from_config(cls, tc, pz) -> "Transport":
        return cls()

    def aggregate(self, p: torch.Tensor, ctl: Dict) -> torch.Tensor:
        """Recover p̂ from the [K] payload vector under this round's
        control block (noise row included)."""
        raise NotImplementedError

    def make_schedule(self, trace, pz):
        raise NotImplementedError

    def charges_privacy(self, schedule, pz) -> bool:
        return False

    def round_dp_costs(self, schedule, t0: int, t1: int, pz) -> np.ndarray:
        return np.zeros(t1 - t0)

    def payload_bits(self, pz, d: int) -> int:
        """Uplink bits one client sends per round (d = model dimension)."""
        raise NotImplementedError


def ota_dp_costs(schedule, t0: int, t1: int, gamma: float) -> np.ndarray:
    """Eq.-16 terms for rounds [t0, t1), bit-equal to the reference."""
    c = np.asarray(schedule.c[t0:t1], dtype=np.float64)
    sigma = np.asarray(schedule.sigma[t0:t1], dtype=np.float64)
    m = np.sqrt(c * c * np.sum(sigma ** 2, axis=1) + schedule.n0)
    return np.asarray([round_privacy_cost(float(c[r]), gamma, float(m[r]))
                       if c[r] != 0.0 else 0.0 for r in range(len(c))])


_REGISTRY: Dict[str, Type[Transport]] = {}


def register(name: str):
    """Class decorator adding a Transport under `name`."""
    def deco(cls: Type[Transport]) -> Type[Transport]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get(name: str) -> Type[Transport]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"transport {name!r} is not ported (ROADMAP A4: other "
            f"transports); ported: {sorted(_REGISTRY)}") from None


def resolve(pz) -> Transport:
    """The Transport a PairZeroConfig asks for: `pz.transport` when set,
    else the legacy `variant` + `power.scheme` strings."""
    tc = pz.transport
    if tc is not None:
        return get(tc.mechanism).from_config(tc, pz)
    return get(pz.variant)(scheme=pz.power.scheme)


@register("analog")
@dataclass(frozen=True)
class AnalogOTA(Transport):
    """Analog pAirZero: clipped projection over superposing OTA, channel
    inversion, Theorem-3 power control. Payload: one fp16 scalar per
    perturbation direction; privacy: channel noise per Lemma 1."""
    scheme: str = "solution"

    @classmethod
    def from_config(cls, tc, pz) -> "AnalogOTA":
        return cls(scheme=tc.scheme)

    def aggregate(self, p, ctl):
        return ota.analog_ota(p, ctl["c"], ctl["sigma"], ctl["n0"],
                              ctl["noise"], ctl["mask"], ctl["g"])[0]

    def make_schedule(self, trace, pz):
        from repro_torch.core import power_control as pc
        if self.scheme != "solution":
            raise NotImplementedError(
                f"power-control scheme {self.scheme!r} is not ported "
                "(ROADMAP A2: static/reversed/sign schedules); only "
                "'solution'")
        return pc.solve_analog(
            np.asarray(trace.h, dtype=np.float64), power=pz.channel.power,
            n0=pz.channel.n0, gamma=pz.zo.clip_gamma,
            contraction_a=pz.power.contraction_a, epsilon=pz.dp.epsilon,
            delta=pz.dp.delta)

    def charges_privacy(self, schedule, pz) -> bool:
        return bool(pz.dp.enabled and schedule.scheme != "perfect")

    def round_dp_costs(self, schedule, t0, t1, pz):
        return ota_dp_costs(schedule, t0, t1, pz.zo.clip_gamma)

    def payload_bits(self, pz, d):
        return 16 * pz.zo.n_perturb
