"""Dense decoder-only transformer, ported from `repro.models.transformer`.

Layers keep the reference's scan-stacked layout (leading L dim on every
block leaf) so that leaf enumeration and per-leaf counter streams match;
`forward` is a Python loop over the layer dim taking views.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dict of (shape, init) per leaf, init a `layers.Normal` on the
    reference's key path (`repro.models.transformer.init`: split(key, 4)
    → blocks vmapped over split(ks[0], L), embed ks[1], lm_head ks[2]; a
    block's split(k, 4) → attn `gqa_init` ks[0], mlp `mlp_init` ks[1]) and
    scale (`layers._init`), or None for the ones-initialized norms."""
    if cfg.moe.enabled or cfg.mla.enabled:
        raise NotImplementedError(
            f"{cfg.name}: MoE / MLA layers are not ported (ROADMAP A8: "
            "other families)")
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    hq, hkv, hd, f = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(),
                      cfg.d_ff)
    blocks = L.sub(L.sub((), 4, 0), n, None)
    attn, mlp = L.sub(blocks, 4, 0), L.sub(blocks, 4, 1)
    specs = {
        "blocks": {
            "attn": L.gqa_specs(attn, (n,), cfg),
            "ln1": {"g": ((n, d), None)},
            "ln2": {"g": ((n, d), None)},
            "mlp": L.mlp_specs(mlp, (n,), d, f),
        },
        "embed": L.embed_specs(L.sub((), 4, 1), v, d),
        "final_norm": {"g": ((d,), None)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.embed_specs(L.sub((), 4, 2), v, d)
    return specs


def init(cfg: ModelConfig, key, device) -> Dict:
    """f32 params drawn from `key` (a `prng` key) as the reference's."""
    return L.init_from_specs(param_specs(cfg), key, device)


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

