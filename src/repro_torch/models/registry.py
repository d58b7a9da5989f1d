"""Architecture-family registry (the dense and ssm families in this port).

Each family module gives `param_specs(cfg)` (a nested dict of (shape,
init) per leaf), `init` and `loss_per_client`. Leaves enumerate in
sorted-key order, as JAX flattens the reference's param dicts.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm}


def get_module(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported (ROADMAP A8: "
            f"other families); ported: {sorted(_FAMILIES)}") from None


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return get_module(cfg).init(cfg, generator, device)


def shapes(cfg: ModelConfig) -> Tuple:
    """Leaf shapes in flattening order (sorted keys)."""
    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k])
        else:
            yield node[0]
    return tuple(walk(get_module(cfg).param_specs(cfg)))


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in shapes(cfg)))
