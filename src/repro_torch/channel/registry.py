"""ChannelModel protocol + registry (mirrors `repro.channel.registry`).

A ChannelModel owns host-side trace synthesis: `realize(seed, rounds,
n_clients) -> ChannelTrace`. Models are frozen dataclasses registered by
name; wrapper models (geometry, imperfect CSI, outage) hold a `base` model
and post-process its trace. `from_config(ChannelConfig)` builds the stack a
run config asks for.
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


def available() -> tuple:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type[ChannelModel]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown channel model {name!r} "
                         f"(registered: {available()})") from None


def from_config(cc) -> ChannelModel:
    """The (possibly wrapped) ChannelModel a ChannelConfig asks for.

    `cc.model` names the fading base (falling back to `cc.fading`); the
    wrappers stack on top in the reference's fixed order — geometry scales
    magnitudes, CSI error rotates phases, outage thresholds the result. A
    field that would be dropped silently (Doppler without ar1, shadowing
    without a cell) raises."""
    from repro_torch.channel import wrappers as wr
    base_name = cc.model or cc.fading
    if getattr(cc, "doppler_hz", None) is not None and base_name != "ar1":
        raise ValueError(
            f"doppler_hz is set but channel model is {base_name!r}: the "
            "Jakes mapping parameterizes the AR(1) correlation — select "
            "model='ar1' (or unset doppler_hz)")
    model = get(base_name).from_config(cc)
    if cc.cell_radius > 0.0:
        model = wr.PathLossGeometry(
            base=model, cell_radius=cc.cell_radius,
            pathloss_exp=cc.pathloss_exp,
            shadow_std_db=getattr(cc, "shadow_std_db", 0.0),
            shadow_corr=getattr(cc, "shadow_corr", 0.5))
    elif getattr(cc, "shadow_std_db", 0.0) > 0.0:
        raise ValueError(
            "shadow_std_db is set but cell_radius == 0: log-normal "
            "shadowing perturbs the PathLossGeometry gains — set "
            "cell_radius > 0 to enable the geometry wrapper")
    if cc.phase_err_std > 0.0:
        model = wr.ImperfectCSI(base=model, phase_err_std=cc.phase_err_std)
    if cc.outage_db is not None:
        model = wr.OutageModel(base=model, threshold_db=cc.outage_db)
    return model


def realize_from_config(cc, seed: int, rounds: int,
                        n_clients: int) -> ChannelTrace:
    """Config -> composed model -> realized trace."""
    return from_config(cc).realize(seed, rounds, n_clients)
