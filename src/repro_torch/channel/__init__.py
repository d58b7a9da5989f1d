"""Wireless channel realization (host-side numpy, bitwise equal to
`repro.channel`): the fading models rayleigh, static, rician and ar1, and
the geometry, imperfect-CSI and outage wrappers."""
from repro_torch.channel.models import (AR1Correlated, RayleighFading,
                                        RicianFading, StaticChannel,
                                        bessel_j0, jakes_rho)
from repro_torch.channel.registry import (ChannelModel, available,
                                          from_config, get,
                                          realize_from_config, register)
from repro_torch.channel.trace import ChannelTrace
from repro_torch.channel.wrappers import (ImperfectCSI, OutageModel,
                                          PathLossGeometry)

__all__ = [
    "AR1Correlated", "ChannelModel", "ChannelTrace", "ImperfectCSI",
    "OutageModel", "PathLossGeometry", "RayleighFading", "RicianFading",
    "StaticChannel", "available", "bessel_j0", "from_config", "get",
    "jakes_rho", "realize_from_config", "register",
]
