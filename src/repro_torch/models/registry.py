"""Architecture-family registry, as `repro.models.registry`: dense and
moe share the transformer module, vlm wraps it, audio is the
encoder-decoder, and the ssm and hybrid families have their own.

Each family module gives `param_specs(cfg)` (nested dicts and lists of
(shape, init) per leaf), `init` and `loss_per_client`, and for serving
`prefill`, `decode_step` and its decode state (`init_cache` of the dense,
moe, vlm and audio families, `init_state` of the ssm and hybrid ones).
Leaves enumerate as JAX flattens the reference's params: dicts by sorted
key, lists by index. Shapes come from the specs on the meta device, so
nothing is allocated even for the 236B config.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import A12, resolve_dtype
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.zo import flatten
from repro_torch.models import encdec, hybrid, ssm, transformer, vlm

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": vlm,
             "audio": encdec, "hybrid": hybrid, "ssm": ssm}


def get_module(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(
            f"unknown family {cfg.family!r} for {cfg.name}") from None


def check_dtype(cfg: ModelConfig, dtype: torch.dtype) -> None:
    """Raise NotImplementedError naming ROADMAP A12 where the port does not
    hold `cfg` in `dtype` against the reference: bf16 runs the dense
    family's GQA models only (not the ssm, hybrid, vlm or audio families,
    nor MLA or MoE)."""
    if dtype == torch.float32:
        return
    if cfg.family != "dense" or cfg.mla.enabled or cfg.moe.enabled:
        what = "MLA" if cfg.mla.enabled else "MoE" if cfg.moe.enabled \
            else f"the {cfg.family} family"
        raise NotImplementedError(
            f"{cfg.name} in {dtype}: {what} is not ported in {dtype} "
            f"({A12}); the dense family's GQA models are")


def init_params(cfg: ModelConfig, key: torch.Tensor, device,
                dtype=torch.float32) -> Dict:
    """`repro.models.registry.init_params(key, cfg, dtype)`'s weights:
    every leaf drawn from `key` (a `repro_torch.prng` key, e.g.
    `prng.key(seed)`) along the reference's key tree, on `device`, in
    `dtype` (float32, or bfloat16 for the dense family: `check_dtype`)."""
    dtype = resolve_dtype(dtype)
    check_dtype(cfg, dtype)
    mod = get_module(cfg)
    if dtype == torch.float32:
        return mod.init(cfg, key, device)
    return mod.init(cfg, key, device, dtype)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    """Every leaf as a meta-device tensor (shape and dtype, nothing
    allocated), in the params' nesting: the counterpart of the reference's
    `jax.eval_shape` of `init`, with its default dtype."""
    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return torch.empty(node[0], dtype=dtype, device="meta")
    return build(get_module(cfg).param_specs(cfg))


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


def train_batch_shapes(cfg: ModelConfig, shape: ShapeConfig,
                       n_clients: int) -> Dict[str, torch.Tensor]:
    """The train batch as meta-device tensors: tokens/targets/mask
    [K, b, S], and the stub frontend's prefix_embeds [K, b, P, D] (bf16, as
    the reference's) when the config has one."""
    assert shape.global_batch % n_clients == 0, \
        f"global_batch {shape.global_batch} not divisible by K={n_clients}"
    lead = (n_clients, shape.global_batch // n_clients)
    meta = lambda dims, dtype: torch.empty(  # noqa: E731
        lead + dims, dtype=dtype, device="meta")
    spec = {"tokens": meta((shape.seq_len,), torch.int32),
            "targets": meta((shape.seq_len,), torch.int32),
            "mask": meta((shape.seq_len,), torch.float32)}
    if cfg.frontend.kind != "none":
        spec["prefix_embeds"] = meta(
            (cfg.frontend.n_frontend_tokens, cfg.d_model), torch.bfloat16)
    return spec


def serve_cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16) -> Dict:
    """The family's decode state as meta-device tensors (shapes and dtypes,
    nothing allocated): the port's counterpart of the reference's
    `jax.eval_shape` of `init_state` / `init_cache`, with its default
    dtype. `max_len` sizes the KV cache of the dense, moe and vlm families
    (MLA's latent cache too) and the audio family's self cache, whose
    cross cache holds the config's `n_frontend_tokens` frames; the ssm and
    hybrid states do not depend on it."""
    mod = get_module(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return mod.init_state(cfg, batch, dtype=dtype, device="meta")
    return mod.init_cache(cfg, batch, max_len, dtype=dtype, device="meta")
