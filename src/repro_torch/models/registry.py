"""Architecture-family registry (dense only in this port)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def get_module(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported (ROADMAP A8: "
            "other families); only dense")
    return transformer


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    return get_module(cfg).init(cfg, generator, device)


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in get_module(cfg).shapes(cfg)))
