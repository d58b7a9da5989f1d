"""Architecture-family registry (the dense, ssm and hybrid families in
this port).

Each family module gives `param_specs(cfg)` (nested dicts and lists of
(shape, init) per leaf), `init` and `loss_per_client`. Leaves enumerate
as JAX flattens the reference's params: dicts by sorted key, lists by
index.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.zo import flatten
from repro_torch.models import hybrid, ssm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm, "hybrid": hybrid}


def get_module(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported (ROADMAP A8: "
            f"other families); ported: {sorted(_FAMILIES)}") from None


def init_params(cfg: ModelConfig, key: torch.Tensor, device) -> Dict:
    """`repro.models.registry.init_params(key, cfg)`'s weights: every leaf
    drawn from `key` (a `repro_torch.prng` key, e.g. `prng.key(seed)`)
    along the reference's key tree, on `device`."""
    return get_module(cfg).init(cfg, key, device)


def shapes(cfg: ModelConfig) -> Tuple:
    """Leaf shapes in flattening order (sorted keys, lists by index)."""
    return tuple(spec[0] for _, spec in
                 flatten(get_module(cfg).param_specs(cfg)))


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in shapes(cfg)))
