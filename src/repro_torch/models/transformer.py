"""Decoder-only transformer (the dense and moe families: GQA or MLA
attention, a SwiGLU MLP or MoE), ported from `repro.models.transformer`.

Layers keep the reference's scan-stacked layout (leading L dim on every
block leaf) so that leaf enumeration and per-leaf counter streams match;
`forward` is a Python loop over the layer dim taking views.

Entry points, as the reference's shape cells:
  * loss_per_client — train shapes (the ZO/FO objective);
  * prefill         — build the KV cache of a prompt, last logits;
  * decode_step     — one token against the cache, written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dict of (shape, init) per leaf, init a `layers.Normal` on the
    reference's key path (`repro.models.transformer.init`: split(key, 4)
    → blocks vmapped over split(ks[0], L), embed ks[1], lm_head ks[2]; a
    block's split(k, 4) → attn (`mla_init` or `gqa_init`) ks[0], moe
    (`moe_init`) or mlp (`mlp_init`) ks[1]) and scale (`layers._init`),
    or None for the ones-initialized norms."""
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    blocks = L.sub(L.sub((), 4, 0), n, None)
    attn, ffn = L.sub(blocks, 4, 0), L.sub(blocks, 4, 1)
    block = {
        "attn": (L.mla_specs(attn, (n,), cfg) if cfg.mla.enabled
                 else L.gqa_specs(attn, (n,), cfg)),
        "ln1": {"g": ((n, d), None)},
        "ln2": {"g": ((n, d), None)},
    }
    if cfg.moe.enabled:
        block["moe"] = L.moe_specs(ffn, (n,), cfg)
    else:
        block["mlp"] = L.mlp_specs(ffn, (n,), d, cfg.d_ff)
    specs = {
        "blocks": block,
        "embed": L.embed_specs(L.sub((), 4, 1), v, d),
        "final_norm": {"g": ((d,), None)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.embed_specs(L.sub((), 4, 2), v, d)
    return specs


def init(cfg: ModelConfig, key, device, dtype=torch.float32) -> Dict:
    """Params in `dtype` drawn from `key` (a `prng` key) as the
    reference's."""
    return L.init_from_specs(param_specs(cfg), key, device, dtype)


def _block_apply(bp: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, cache: Optional[Dict] = None,
                 cache_pos: Optional[int] = None) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if cfg.mla.enabled:
        x = x + L.mla_attend(bp["attn"], h, positions, cfg, kv_cache=cache,
                             cache_pos=cache_pos)
    else:
        x = x + L.gqa_attend(bp["attn"], h, positions, cfg, causal=True,
                             kv_cache=cache, cache_pos=cache_pos)
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if cfg.moe.enabled:
        return x + L.moe(bp["moe"], h, cfg)
    return x + L.mlp(bp["mlp"], h)


def forward(params: Dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            *, prefix_embeds: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: [B, S] → hidden [B, S(+P), D]. `prefix_embeds` [B, P, D]
    are prepended (the vlm's stub frontend); `inputs_embeds` [B, S, D]
    replace the embedding lookup (tokens may be None), as the reference's
    continuous input surface."""
    x = L.embed(params["embed"], tokens) if inputs_embeds is None \
        else inputs_embeds
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _block_apply(L.layer_slice(params["blocks"], i), x, positions,
                         cfg)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def logits_from_hidden(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [.., V] of hidden states [.., D] (the reference's name
    for `layers.logits`)."""
    return L.logits(params, x)


def token_nll(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              targets: torch.Tensor, mask: torch.Tensor, *,
              prefix_embeds: Optional[torch.Tensor] = None,
              inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row mean NLL [B] of tokens/targets/mask [B, S], scored on the
    text positions only (the prefix's are sliced off)."""
    x = forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                inputs_embeds=inputs_embeds)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    return L.cross_entropy(logits_from_hidden(params, x), targets, mask)


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    """batch tokens/targets/mask: [K, b, S] (and the vlm's prefix_embeds
    [K, b, P, D] when present) → per-client losses [K]."""
    return L.loss_per_client(forward, params, cfg, batch)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda") -> Dict:
    """Zero KV cache {"k", "v": [L, B, max_len, Hkv, hd]} on `device`;
    under MLA the latent cache {"ckv": [L, B, max_len, kv_lora_rank],
    "krope": [L, B, max_len, qk_rope_head_dim]}."""
    if cfg.mla.enabled:
        lead = (cfg.n_layers, batch, max_len)
        return {"ckv": torch.zeros(lead + (cfg.mla.kv_lora_rank,),
                                   dtype=dtype, device=device),
                "krope": torch.zeros(lead + (cfg.mla.qk_rope_head_dim,),
                                     dtype=dtype, device=device)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer_cache(cache: Dict, i: int) -> Dict:
    """Views of layer i of the stacked cache (writes land in the stack)."""
    return {name: c[i] for name, c in cache.items()}


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, cache_pos: int
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens [B, S_new(=1)] at `cache_pos` (a host int)
    → (logits [B, S_new, V], cache). Each layer attends over its view of
    the stacked cache and writes its new k/v there in place, so the
    returned cache is the same buffer (the reference's donated carry)."""
    x = L.embed(params["embed"], tokens)
    positions = cache_pos + torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _block_apply(L.layer_slice(params["blocks"], i), x, positions,
                         cfg, cache=_layer_cache(cache, i),
                         cache_pos=cache_pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, x), cache


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence prefill of `prefix_embeds` [B, P, D] (if given) and
    tokens [B, S]: (last-position logits [B, 1, V], cache [L, B, P + S,
    Hkv, hd], or MLA's latent cache [L, B, P + S, R] and [.., dr]). Each
    block runs its training form (attention through the kernel), and its
    k/v (or latent) are recomputed from the block input into the cache
    (one extra projection a layer, as the reference does)."""
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, s, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        bp = L.layer_slice(params["blocks"], i)
        h_in = x
        x = _block_apply(bp, x, positions, cfg)
        _fill_cache(bp, L.rmsnorm(bp["ln1"], h_in, cfg.norm_eps),
                    _layer_cache(cache, i), positions, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, x[:, -1:]), cache


def _fill_cache(bp: Dict, h_norm: torch.Tensor, layer_cache: Dict,
                positions: torch.Tensor, cfg: ModelConfig) -> None:
    """Write this layer's roped k and its v (MLA: its normed latent and
    roped key) into its cache views. (The reference's `sharding.hint` on
    these writes lays the cache out over a mesh: ROADMAP A11.)"""
    b, s, _ = h_norm.shape
    if cfg.mla.enabled:
        ckv, krope = L.mla_latent(bp["attn"], h_norm, positions, cfg)
        layer_cache["ckv"][:, :s] = ckv
        layer_cache["krope"][:, :s] = krope
        return
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    k = L.dense({"w": bp["attn"]["wk"]}, h_norm).reshape(b, s, hkv, hd)
    k = L.rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    v = L.dense({"w": bp["attn"]["wv"]}, h_norm).reshape(b, s, hkv, hd)
    layer_cache["k"][:, :s] = k
    layer_cache["v"][:, :s] = v
