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

def _dense(lead: tuple, d_in: int, d_out: int) -> Dict:
    return {"w": (lead + (d_in, d_out), 1.0 / math.sqrt(d_in))}


def _norm(lead: tuple, d: int) -> Dict:
    return {"g": (lead + (d,), None)}


def _mlp(lead: tuple, d: int, f: int) -> Dict:
    return {"wd": (lead + (f, d), 1.0 / math.sqrt(f)),
            "wg": (lead + (d, f), 1.0 / math.sqrt(d)),
            "wi": (lead + (d, f), 1.0 / math.sqrt(d))}


def _rglru_specs(cfg: ModelConfig, lead: tuple) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    w = cfg.hybrid.lru_width or d
    cw = cfg.hybrid.conv1d_width
    return {
        "conv_w": (lead + (cw, w), 1.0 / math.sqrt(cw)),
        "lambda_p": (lead + (w,), L.Fill(2.0)),       # softplus param
        "lin_gate": _dense(lead, d, w),
        "lin_x": _dense(lead, d, w),
        "mlp": _mlp(lead, d, f),
        "mlp_norm": _norm(lead, d),
        "norm": _norm(lead, d),
        "out": _dense(lead, w, d),
        "w_in_gate": _dense(lead, w, w),
        "w_rec_gate": _dense(lead, w, w),
    }


def _attn_specs(cfg: ModelConfig, lead: tuple) -> Dict:
    d = cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    return {
        "attn": {"wk": (lead + (d, hkv * hd), 1.0 / math.sqrt(d)),
                 "wo": (lead + (hq * hd, d), 1.0 / math.sqrt(hq * hd)),
                 "wq": (lead + (d, hq * hd), 1.0 / math.sqrt(d)),
                 "wv": (lead + (d, hkv * hd), 1.0 / math.sqrt(d))},
        "mlp": _mlp(lead, d, cfg.d_ff),
        "mlp_norm": _norm(lead, d),
        "norm": _norm(lead, d),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dicts and lists of (shape, init) per leaf: init is the
    normal std of the reference's initializer, None for ones, or a
    `layers.Fill` (`init` builds the tensors)."""
    if cfg.hybrid.pattern != "rra":
        raise ValueError("the hybrid family uses the 1:2 rra pattern")
    n_groups, tail = _group_counts(cfg)
    lead = (n_groups,)
    v, d = cfg.vocab_size, cfg.d_model
    specs = {
        "embed": {"w": ((v, d), 0.02)},
        "final_norm": _norm((), d),
        "groups": {"a": _attn_specs(cfg, lead),
                   "r1": _rglru_specs(cfg, lead),
                   "r2": _rglru_specs(cfg, lead)},
        "tail": [_rglru_specs(cfg, ()) for _ in range(tail)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((v, d), 0.02)}
    return specs


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    """Random f32 params at the reference's scales."""
    return L.init_from_specs(param_specs(cfg), generator, device)


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
