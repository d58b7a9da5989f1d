"""Mamba-2 (SSD) language model, the attention-free family, ported from
`repro.models.ssm` (training forward; the serve path waits for ROADMAP A8).

Block (arXiv:2405.21060): in_proj → (z gate | xBC | dt) with a causal
depthwise conv over xBC → SSD mixing (`kernels.ops.ssd`: the CUDA kernel
on the card, the plain version on the CPU) → gated RMSNorm → out_proj.
Layers keep the reference's scan-stacked layout and sorted-key leaf order
(blocks.{a_log, conv_w, dt_bias, gate_norm.g, in_proj.w, norm.g,
out_proj.w}, embed.w, final_norm.g), on which every leaf seed depends.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.d_state, s.d_conv, s.head_dim


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dict of (shape, init) per leaf, init a `layers.Normal` on the
    reference's key path (`repro.models.ssm.init`: split(key, 3) → blocks
    vmapped over split(ks[0], L), embed ks[1], lm_head ks[2]; a block's
    split(k, 5) → in_proj ks[0], conv_w ks[1] divided by √d_conv,
    out_proj ks[2]), None for ones, or `layers.ZEROS`."""
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    d_inner, h, d_state, d_conv, _ = _dims(cfg)
    conv_ch = d_inner + 2 * d_state          # x, B, C share the conv
    blocks = L.sub(L.sub((), 3, 0), n, None)
    specs = {
        "blocks": {
            "a_log": ((n, h), L.ZEROS),
            "conv_w": ((n, d_conv, conv_ch), L.Normal(
                L.sub(blocks, 5, 1), divisor=math.sqrt(d_conv))),
            "dt_bias": ((n, h), L.ZEROS),
            "gate_norm": L.norm_specs((n,), d_inner),
            "in_proj": L.dense_specs(L.sub(blocks, 5, 0), (n,), d,
                                     2 * d_inner + 2 * d_state + h),
            "norm": L.norm_specs((n,), d),
            "out_proj": L.dense_specs(L.sub(blocks, 5, 2), (n,), d_inner,
                                      d),
        },
        "embed": L.embed_specs(L.sub((), 3, 1), v, d),
        "final_norm": L.norm_specs((), d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.embed_specs(L.sub((), 3, 2), v, d)
    return specs


def init(cfg: ModelConfig, key, device) -> Dict:
    """f32 params drawn from `key` (a `prng` key) as the reference's."""
    return L.init_from_specs(param_specs(cfg), key, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU. x: [B, S, C]; w: [W, C] → [B, S, C]."""
    b, s, c = x.shape
    wlen = w.shape[0]
    xp = torch.cat([x.new_zeros((b, wlen - 1, c)), x], dim=1)
    # the reference's Python sum: 0 + term 0 + term 1 + ...
    y = sum(xp[:, i:i + s] * w[i][None, None].to(x.dtype)
            for i in range(wlen))
    return F.silu(y.to(torch.float32)).to(x.dtype)


def _block_apply(bp: Dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """One Mamba-2 block in its training form: x [B, S, D] → [B, S, D]."""
    b, s, _ = x.shape
    d_inner, h, n, _, p_dim = _dims(cfg)
    res = x
    xn = L.rmsnorm(bp["norm"], x, cfg.norm_eps)
    zxbcdt = L.dense(bp["in_proj"], xn)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * n]
    dt_raw = zxbcdt[..., -h:]

    xbc = _causal_conv(xbc, bp["conv_w"])
    xs = xbc[..., :d_inner].reshape(b, s, h, p_dim)
    b_mat = xbc[..., d_inner:d_inner + n]
    c_mat = xbc[..., d_inner + n:]
    # jax.nn.softplus has no threshold; torch's returns x above 20, where
    # log1p(exp(-x)) < 2.1e-9 is below half an f32 ulp of x: the two agree
    dt = F.softplus(dt_raw.to(torch.float32) + bp["dt_bias"][None, None])
    a = -torch.exp(bp["a_log"])

    chunk = min(cfg.ssm.chunk, s)
    if s % chunk != 0:
        chunk = s
    y, _ = kops.ssd(xs, dt, a, b_mat, c_mat, chunk=chunk, want_state=False)

    y = y.reshape(b, s, d_inner)
    y = L.rmsnorm(bp["gate_norm"],
                  y * F.silu(z.to(torch.float32)).to(y.dtype), cfg.norm_eps)
    # the reference's row-parallel `dense_rp` is `dense` on one device
    return res + L.dense(bp["out_proj"], y)


def forward(params: Dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] → hidden [B, S, D]."""
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x = _block_apply(L.layer_slice(params["blocks"], i), x, cfg)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    """batch tokens/targets/mask: [K, b, S] → per-client losses [K]."""
    return L.loss_per_client(forward, params, cfg, batch)

