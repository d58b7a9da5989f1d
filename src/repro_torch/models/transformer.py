"""Dense decoder-only transformer, ported from `repro.models.transformer`.

Layers keep the reference's scan-stacked layout (leading L dim on every
block leaf) so that leaf enumeration and per-leaf counter streams match;
`forward` is a Python loop over the layer dim taking views.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dict of (shape, init) per leaf: init is the normal std of
    `repro.models.layers._init`, or None for the ones-initialized norms
    (`init` builds the tensors)."""
    if cfg.moe.enabled or cfg.mla.enabled:
        raise NotImplementedError(
            f"{cfg.name}: MoE / MLA layers are not ported (ROADMAP A8: "
            "other families)")
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    hq, hkv, hd, f = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(),
                      cfg.d_ff)
    specs = {
        "blocks": {
            "attn": {"wq": ((n, d, hq * hd), 1.0 / math.sqrt(d)),
                     "wk": ((n, d, hkv * hd), 1.0 / math.sqrt(d)),
                     "wv": ((n, d, hkv * hd), 1.0 / math.sqrt(d)),
                     "wo": ((n, hq * hd, d), 1.0 / math.sqrt(hq * hd))},
            "ln1": {"g": ((n, d), None)},
            "ln2": {"g": ((n, d), None)},
            "mlp": {"wi": ((n, d, f), 1.0 / math.sqrt(d)),
                    "wg": ((n, d, f), 1.0 / math.sqrt(d)),
                    "wd": ((n, f, d), 1.0 / math.sqrt(f))},
        },
        "embed": {"w": ((v, d), 0.02)},
        "final_norm": {"g": ((d,), None)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((v, d), 0.02)}
    return specs



def init(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    """Random f32 params at the reference's scales."""
    return L.init_from_specs(param_specs(cfg), generator, device)

def _block_apply(bp: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + L.gqa_attend(bp["attn"], h, positions, cfg, causal=True)
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h)


def forward(params: Dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] → hidden [B, S, D]."""
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _block_apply(L.layer_slice(params["blocks"], i), x, positions,
                         cfg)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    """batch tokens/targets/mask: [K, b, S] → per-client losses [K]."""
    return L.loss_per_client(forward, params, cfg, batch)

