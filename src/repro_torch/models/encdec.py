"""Whisper-style encoder-decoder (the audio family), ported from
`repro.models.encdec`.

The conv frontend is a stub, as in the reference: the batch supplies
precomputed frame embeddings [B, n_frames, d_model] under `prefix_embeds`
(1500 frames, 30 s of audio, for whisper-medium). The encoder is
bidirectional self-attention (roped, non-causal); each decoder block has
causal self-attention, then cross-attention (not roped) to the encoder's
output, then the SwiGLU MLP. Attention over whole sequences goes through
`kops.attention` (the kernel on the card); decode attention is plain f32,
as in the reference.

Both block stacks keep the reference's scan-stacked layout (a leading
layer dim on every leaf) and its leaves' sorted order, so per-leaf seeds
and counters match. Serving keeps a self cache that grows with the
decoded tokens and a cross cache over all frames, filled once by
`prefill`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dict of (shape, init) per leaf on the reference's key path
    (`repro.models.encdec.init`: split(key, 5) → encoder blocks vmapped
    over split(ks[0], n_enc), each split(k, 2) → attn, mlp; decoder
    blocks over split(ks[1], L), each split(k, 3) → self_attn,
    cross_attn, mlp; dec_embed ks[2]; lm_head ks[3] unless tied)."""
    n_dec, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    enc = L.sub(L.sub((), 5, 0), n_enc, None)
    dec = L.sub(L.sub((), 5, 1), n_dec, None)
    specs = {
        "enc_blocks": {
            "attn": L.gqa_specs(L.sub(enc, 2, 0), (n_enc,), cfg),
            "ln1": L.norm_specs((n_enc,), d),
            "ln2": L.norm_specs((n_enc,), d),
            "mlp": L.mlp_specs(L.sub(enc, 2, 1), (n_enc,), d, cfg.d_ff),
        },
        "enc_norm": L.norm_specs((), d),
        "dec_embed": L.embed_specs(L.sub((), 5, 2), v, d),
        "dec_blocks": {
            "cross_attn": L.gqa_specs(L.sub(dec, 3, 1), (n_dec,), cfg),
            "ln1": L.norm_specs((n_dec,), d),
            "ln2": L.norm_specs((n_dec,), d),
            "ln_x": L.norm_specs((n_dec,), d),
            "mlp": L.mlp_specs(L.sub(dec, 3, 2), (n_dec,), d, cfg.d_ff),
            "self_attn": L.gqa_specs(L.sub(dec, 3, 0), (n_dec,), cfg),
        },
        "dec_norm": L.norm_specs((), d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.embed_specs(L.sub((), 5, 3), v, d)
    return specs


def init(cfg: ModelConfig, key, device) -> Dict:
    """f32 params drawn from `key` (a `prng` key) as the reference's."""
    return L.init_from_specs(param_specs(cfg), key, device)


def encode(params: Dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames [B, T, D] (the stub frontend's output) → encoder hidden
    [B, T, D]."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames
    for i in range(cfg.n_encoder_layers or cfg.n_layers):
        bp = L.layer_slice(params["enc_blocks"], i)
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        x = x + L.gqa_attend(bp["attn"], h, positions, cfg, causal=False)
        x = x + L.mlp(bp["mlp"], L.rmsnorm(bp["ln2"], x, cfg.norm_eps))
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_block_apply(bp: Dict, x: torch.Tensor, enc_out: torch.Tensor,
                     positions: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + L.gqa_attend(bp["self_attn"], h, positions, cfg, causal=True)
    h = L.rmsnorm(bp["ln_x"], x, cfg.norm_eps)
    x = x + L.gqa_attend(bp["cross_attn"], h, positions, cfg, causal=False,
                         kv_x=enc_out)
    return x + L.mlp(bp["mlp"], L.rmsnorm(bp["ln2"], x, cfg.norm_eps))


def decode_hidden(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] against the encoder's output → hidden [B, S, D]."""
    x = L.embed(params["dec_embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _dec_block_apply(L.layer_slice(params["dec_blocks"], i), x,
                             enc_out, positions, cfg)
    return L.rmsnorm(params["dec_norm"], x, cfg.norm_eps)


def _frames(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: Optional[torch.Tensor]) -> torch.Tensor:
    """`frames`, or where none are given the zero frames [B,
    n_frontend_tokens, D] that the reference serves and evaluates on."""
    if frames is not None:
        return frames
    return torch.zeros((tokens.shape[0], cfg.frontend.n_frontend_tokens,
                        cfg.d_model), dtype=params["enc_norm"]["g"].dtype,
                       device=tokens.device)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] and the frames [B, T, D] (the batch's name for them,
    `prefix_embeds`; zero frames if none) → decoder hidden [B, S, D]."""
    frames = _frames(params, cfg, tokens, prefix_embeds)
    return decode_hidden(params, cfg, tokens, encode(params, cfg, frames))


def token_nll(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              targets: torch.Tensor, mask: torch.Tensor, *,
              frames: Optional[torch.Tensor] = None,
              prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row mean NLL [B] of tokens/targets/mask [B, S] given the frames
    [B, T, D] (`frames`, or the batch's name for them, `prefix_embeds`)."""
    x = forward(params, cfg, tokens,
                prefix_embeds=frames if frames is not None else prefix_embeds)
    return L.cross_entropy(L.logits(params, x), targets, mask)


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    """batch tokens/targets/mask [K, b, S] and frames prefix_embeds
    [K, b, T, D] → per-client losses [K]."""
    return L.loss_per_client(forward, params, cfg, batch)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda",
               n_frames: Optional[int] = None) -> Dict:
    """Zero caches on `device`: the decoder's self k/v {"self_k",
    "self_v": [L, B, max_len, Hkv, hd]} and the cross k/v of the frames
    {"cross_k", "cross_v": [L, B, n_frames, Hkv, hd]}, the config's
    `n_frontend_tokens` frames unless `n_frames` says otherwise."""
    if n_frames is None:
        n_frames = cfg.frontend.n_frontend_tokens
    lead = (cfg.n_layers, batch)
    tail = (cfg.n_kv_heads, cfg.resolved_head_dim())
    zeros = lambda n: torch.zeros(lead + (n,) + tail, dtype=dtype,  # noqa
                                  device=device)
    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(n_frames), "cross_v": zeros(n_frames)}


def _layer_cache(cache: Dict, i: int) -> Dict:
    """Views of layer i of the stacked caches (writes land in the stack)."""
    return {name: c[i] for name, c in cache.items()}


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Encode the frames `prefix_embeds` [B, T, D] (zero frames if none),
    run the decoder over tokens [B, S]: (last-position
    logits [B, 1, V], caches with the self k/v of the S tokens and the
    cross k/v of the frames). Each decoder block runs its training form,
    and the k/v are recomputed from the block input and the encoder output
    into the cache, as the reference does."""
    b, s = tokens.shape
    frames = _frames(params, cfg, tokens, prefix_embeds)
    enc_out = encode(params, cfg, frames)
    x = L.embed(params["dec_embed"], tokens)
    positions = torch.arange(s, device=x.device)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    cache = init_cache(cfg, b, s, dtype=x.dtype, device=x.device,
                       n_frames=frames.shape[1])
    for i in range(cfg.n_layers):
        bp = L.layer_slice(params["dec_blocks"], i)
        lc = _layer_cache(cache, i)
        h_norm = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        x = _dec_block_apply(bp, x, enc_out, positions, cfg)
        k = L.dense({"w": bp["self_attn"]["wk"]}, h_norm).reshape(
            b, s, hkv, hd)
        lc["self_k"][:] = L.rope(k.transpose(1, 2), positions,
                                 cfg.rope_theta).transpose(1, 2)
        lc["self_v"][:] = L.dense({"w": bp["self_attn"]["wv"]},
                                  h_norm).reshape(b, s, hkv, hd)
        lc["cross_k"][:] = L.dense({"w": bp["cross_attn"]["wk"]},
                                   enc_out).reshape(b, -1, hkv, hd)
        lc["cross_v"][:] = L.dense({"w": bp["cross_attn"]["wv"]},
                                   enc_out).reshape(b, -1, hkv, hd)
    x = L.rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return L.logits(params, x[:, -1:]), cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, cache_pos: int
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens [B, S_new(=1)] at `cache_pos` (a host int)
    → (logits [B, S_new, V], cache). The self k/v are written into the
    self cache in place (the returned cache is the same buffer); the
    cross-attention attends over every frame of the fixed cross cache."""
    b, s = tokens.shape
    hq, hd = cfg.n_heads, cfg.resolved_head_dim()
    x = L.embed(params["dec_embed"], tokens)
    positions = cache_pos + torch.arange(s, device=x.device)
    for i in range(cfg.n_layers):
        bp = L.layer_slice(params["dec_blocks"], i)
        lc = _layer_cache(cache, i)
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        x = x + L.gqa_attend(bp["self_attn"], h, positions, cfg,
                             causal=True, cache_pos=cache_pos,
                             kv_cache={"k": lc["self_k"],
                                       "v": lc["self_v"]})
        h = L.rmsnorm(bp["ln_x"], x, cfg.norm_eps)
        q = L.dense({"w": bp["cross_attn"]["wq"]}, h).reshape(b, s, hq, hd)
        n_frames = lc["cross_k"].shape[1]
        a = L.decode_attend(q, lc["cross_k"], lc["cross_v"],
                            torch.full((s,), n_frames - 1, device=x.device))
        x = x + L.dense({"w": bp["cross_attn"]["wo"]},
                        a.reshape(b, s, hq * hd))
        x = x + L.mlp(bp["mlp"], L.rmsnorm(bp["ln2"], x, cfg.norm_eps))
    x = L.rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return L.logits(params, x), cache
