"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks and local
attention, ported from `repro.models.hybrid` (training forward; the serve
path waits for ROADMAP A8).

Pattern "rra" (2 recurrent : 1 local-attention) cycled over n_layers
(arXiv:2402.19427): 26 layers = 8 × (r, r, a) + (r, r). The full groups
keep the reference's scan-stacked layout (`groups.{a,r1,r2}`, leading
n_groups dim); the leftover recurrent layers are the unstacked list
`tail`, which JAX flattens by index after `groups`. The recurrence goes
through `kernels.ops.linear_recurrence` (the CUDA kernel on the card, the
plain version on the CPU), the attention blocks through
`layers.gqa_attend` with the local window.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

_LRU_C = 8.0   # RG-LRU decay sharpness constant (paper value)


def layer_kinds(cfg: ModelConfig):
    pat = cfg.hybrid.pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _group_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(#full rra groups, #tail recurrent layers)."""
    plen = len(cfg.hybrid.pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _rglru_specs(cfg: ModelConfig, path: tuple, lead: tuple) -> Dict:
    """`_rglru_block_init`: split(key, 7) → lin_x, lin_gate, conv_w
    (divided by √conv1d_width), w_rec_gate, w_in_gate, out, mlp."""
    d, f = cfg.d_model, cfg.d_ff
    w = cfg.hybrid.lru_width or d
    cw = cfg.hybrid.conv1d_width
    ks = lambda i: L.sub(path, 7, i)  # noqa: E731
    return {
        "conv_w": (lead + (cw, w), L.Normal(ks(2), divisor=math.sqrt(cw))),
        "lambda_p": (lead + (w,), L.Fill(2.0)),       # softplus param
        "lin_gate": L.dense_specs(ks(1), lead, d, w),
        "lin_x": L.dense_specs(ks(0), lead, d, w),
        "mlp": L.mlp_specs(ks(6), lead, d, f),
        "mlp_norm": L.norm_specs(lead, d),
        "norm": L.norm_specs(lead, d),
        "out": L.dense_specs(ks(5), lead, w, d),
        "w_in_gate": L.dense_specs(ks(4), lead, w, w),
        "w_rec_gate": L.dense_specs(ks(3), lead, w, w),
    }


def _attn_specs(cfg: ModelConfig, path: tuple, lead: tuple) -> Dict:
    """`_attn_block_init`: split(key, 2) → attn, mlp."""
    d = cfg.d_model
    return {
        "attn": L.gqa_specs(L.sub(path, 2, 0), lead, cfg),
        "mlp": L.mlp_specs(L.sub(path, 2, 1), lead, d, cfg.d_ff),
        "mlp_norm": L.norm_specs(lead, d),
        "norm": L.norm_specs(lead, d),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dicts and lists of (shape, init) per leaf, init a
    `layers.Normal` on the reference's key path (`repro.models.hybrid.init`:
    split(key, 5) → embed ks[0], groups vmapped over split(ks[1], groups)
    with split(k, 3) → r1, r2, a; lm_head ks[2]; tail layer i
    split(ks[3], max(tail, 1))[i]), None for ones, or a `layers.Fill`."""
    if cfg.hybrid.pattern != "rra":
        raise ValueError("the hybrid family uses the 1:2 rra pattern")
    n_groups, tail = _group_counts(cfg)
    lead = (n_groups,)
    v, d = cfg.vocab_size, cfg.d_model
    groups = L.sub(L.sub((), 5, 1), n_groups, None)
    tails = L.sub((), 5, 3)
    specs = {
        "embed": L.embed_specs(L.sub((), 5, 0), v, d),
        "final_norm": L.norm_specs((), d),
        "groups": {"a": _attn_specs(cfg, L.sub(groups, 3, 2), lead),
                   "r1": _rglru_specs(cfg, L.sub(groups, 3, 0), lead),
                   "r2": _rglru_specs(cfg, L.sub(groups, 3, 1), lead)},
        "tail": [_rglru_specs(cfg, L.sub(tails, max(tail, 1), i), ())
                 for i in range(tail)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.embed_specs(L.sub((), 5, 2), v, d)
    return specs


def init(cfg: ModelConfig, key, device) -> Dict:
    """f32 params drawn from `key` (a `prng` key) as the reference's."""
    return L.init_from_specs(param_specs(cfg), key, device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _hybrid_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, no activation. x: [B, S, C]; w: [W, C]."""
    b, s, c = x.shape
    wlen = w.shape[0]
    xp = torch.cat([x.new_zeros((b, wlen - 1, c)), x], dim=1)
    # the reference's Python sum: 0 + term 0 + term 1 + ...
    return sum(xp[:, i:i + s] * w[i][None, None].to(x.dtype)
               for i in range(wlen))


def _rglru_mix(bp: Dict, xn: torch.Tensor) -> torch.Tensor:
    """RG-LRU temporal mixing. xn: [B, S, D_model] (already normed)."""
    xw = L.dense(bp["lin_x"], xn)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(L.dense(bp["lin_gate"], xn).to(torch.float32),
                  approximate="tanh").to(xw.dtype)
    xw = _hybrid_conv(xw, bp["conv_w"])

    r = torch.sigmoid(L.dense(bp["w_rec_gate"], xw).to(torch.float32))
    i = torch.sigmoid(L.dense(bp["w_in_gate"], xw).to(torch.float32))
    # jax.nn.softplus has no threshold; torch's returns x above 20, where
    # log1p(exp(-x)) < 2.1e-9 is below half an f32 ulp of x: the two agree
    log_a = -_LRU_C * F.softplus(bp["lambda_p"])[None, None] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    drive = (beta * i * xw.to(torch.float32)).to(xw.dtype)

    hs, _ = kops.linear_recurrence(a.to(xw.dtype), drive)
    # the reference's row-parallel `dense_rp` is `dense` on one device
    return L.dense(bp["out"], gate * hs)


def _rglru_block_apply(bp: Dict, x: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    x = x + _rglru_mix(bp, L.rmsnorm(bp["norm"], x, cfg.norm_eps))
    return x + L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], x, cfg.norm_eps))


def _attn_block_apply(bp: Dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    h = L.rmsnorm(bp["norm"], x, cfg.norm_eps)
    x = x + L.gqa_attend(bp["attn"], h, positions, cfg, causal=True,
                         window=cfg.hybrid.local_window)
    return x + L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def forward(params: Dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] → hidden [B, S, D]."""
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    n_groups, _ = _group_counts(cfg)
    for g in range(n_groups):
        gp = L.layer_slice(params["groups"], g)
        x = _rglru_block_apply(gp["r1"], x, cfg)
        x = _rglru_block_apply(gp["r2"], x, cfg)
        x = _attn_block_apply(gp["a"], x, positions, cfg)
    for bp in params["tail"]:
        x = _rglru_block_apply(bp, x, cfg)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def token_nll(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row mean NLL [B] of tokens/targets/mask [B, S]."""
    x = forward(params, cfg, tokens)
    logits = L.unembed(params.get("lm_head", params["embed"]), x)
    return L.cross_entropy(logits, targets, mask)


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    """batch tokens/targets/mask: [K, b, S] → per-client losses [K]."""
    return L.loss_per_client(forward, params, cfg, batch)
