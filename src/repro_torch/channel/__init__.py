"""Wireless channel realization (host-side numpy, bitwise equal to
`repro.channel` for the ported models)."""
from repro_torch.channel import models  # noqa: F401  (registers rayleigh)
from repro_torch.channel.registry import ChannelModel, from_config, get
from repro_torch.channel.trace import ChannelTrace

__all__ = ["ChannelModel", "ChannelTrace", "from_config", "get"]
