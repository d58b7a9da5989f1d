"""Architecture-family registry (the dense, moe, ssm and hybrid families
in this port; dense and moe share the transformer module, as in `repro`).

Each family module gives `param_specs(cfg)` (nested dicts and lists of
(shape, init) per leaf), `init` and `loss_per_client`, and for serving
`prefill`, `decode_step` and its decode state (`init_cache` of the dense
family, `init_state` of the ssm and hybrid ones). Leaves enumerate as JAX
flattens the reference's params: dicts by sorted key, lists by index.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.zo import flatten
from repro_torch.models import hybrid, ssm, transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": ssm,
             "hybrid": hybrid}


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


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Every parameter, or (active_only) those one token uses: the routed
    experts it is not sent to left out (the reference's Table II active
    column)."""
    total = int(sum(math.prod(s) for s in shapes(cfg)))
    if active_only and cfg.moe.enabled:
        m = cfg.moe
        inactive = cfg.n_layers * (m.n_experts - m.n_experts_per_tok) \
            * 3 * cfg.d_model * m.d_expert
        return total - inactive
    return total


def serve_cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16) -> Dict:
    """The family's decode state as meta-device tensors (shapes and dtypes,
    nothing allocated): the port's counterpart of the reference's
    `jax.eval_shape` of `init_state` / `init_cache`, with its default
    dtype. `max_len` sizes the KV cache of the dense and moe families
    (MLA's latent cache too); the ssm and hybrid states do not depend on
    it."""
    mod = get_module(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return mod.init_state(cfg, batch, dtype=dtype, device="meta")
    return mod.init_cache(cfg, batch, max_len, dtype=dtype, device="meta")
