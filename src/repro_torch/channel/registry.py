"""ChannelModel protocol + registry (mirrors `repro.channel.registry`).

A ChannelModel owns host-side trace synthesis: `realize(seed, rounds,
n_clients) -> ChannelTrace`. Only the default stack is ported: a plain
Rayleigh model, no geometry / imperfect-CSI / outage wrappers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Type

from repro_torch.channel.trace import ChannelTrace


@dataclass(frozen=True)
class ChannelModel:
    """One wireless channel model. Subclass + `@register(name)` to add one."""

    name = "?"

    @classmethod
    def from_config(cls, cc) -> "ChannelModel":
        return cls()

    def realize(self, seed: int, rounds: int,
                n_clients: int) -> ChannelTrace:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[ChannelModel]] = {}


def register(name: str):
    """Class decorator adding a ChannelModel under `name`."""
    def deco(cls: Type[ChannelModel]) -> Type[ChannelModel]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get(name: str) -> Type[ChannelModel]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"channel model {name!r} is not ported (ROADMAP A2: other "
            f"channel models); ported: {sorted(_REGISTRY)}") from None


def from_config(cc) -> ChannelModel:
    """The ChannelModel a ChannelConfig asks for. Any wrapper field set
    (geometry, imperfect CSI, outage, Doppler) is rejected, not ignored."""
    wrapped = {"cell_radius": cc.cell_radius > 0.0,
               "shadow_std_db": cc.shadow_std_db > 0.0,
               "phase_err_std": cc.phase_err_std > 0.0,
               "outage_db": cc.outage_db is not None,
               "doppler_hz": cc.doppler_hz is not None}
    set_fields = [k for k, v in wrapped.items() if v]
    if set_fields:
        raise NotImplementedError(
            f"ChannelConfig sets {set_fields}: the channel wrappers are not "
            "ported (ROADMAP A2: other channel models and wrappers)")
    return get(cc.model or cc.fading).from_config(cc)
