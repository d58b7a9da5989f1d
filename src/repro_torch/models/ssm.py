"""Mamba-2 (SSD) language model, the attention-free family, ported from
`repro.models.ssm`: the training forward and the serve path (prefill with
the final states, one-token decode on an O(1) state).

Block (arXiv:2405.21060): in_proj → (z gate | xBC | dt) with a causal
depthwise conv over xBC → SSD mixing (`kernels.ops.ssd`: the CUDA kernel
on the card, the plain version on the CPU) → gated RMSNorm → out_proj.
Layers keep the reference's scan-stacked layout and sorted-key leaf order
(blocks.{a_log, conv_w, dt_bias, gate_norm.g, in_proj.w, norm.g,
out_proj.w}, embed.w, final_norm.g), on which every leaf seed depends.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv + SiLU. x: [B, S, C]; w: [W, C]; tail: [B,
    W−1, C] carried state (zeros if None) → (y [B, S, C], new tail)."""
    b, s, c = x.shape
    wlen = w.shape[0]
    if tail is None:
        tail = x.new_zeros((b, wlen - 1, c))
    xp = torch.cat([tail, x], dim=1)
    # the reference's Python sum: 0 + term 0 + term 1 + ...
    y = sum(xp[:, i:i + s] * w[i][None, None].to(x.dtype)
            for i in range(wlen))
    new_tail = xp[:, -(wlen - 1):] if wlen > 1 else tail
    return F.silu(y.to(torch.float32)).to(x.dtype), new_tail


def _block_apply(bp: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                 state: Optional[Dict] = None, want_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba-2 block, x [B, S, D] → ([B, S, D], state or None), in one
    of three forms: training (no state in or out: the SSD kernel's y-only
    entry); prefill (`want_state`: the stateful entry, returning {"ssd":
    [B,H,P,N] f32, "conv": [B,W−1,C]}); decode (`state` given, S = 1: the
    conv tail, then `ops.ssd_decode_step`, returning the new state)."""
    b, s, _ = x.shape
    d_inner, h, n, _, p_dim = _dims(cfg)
    res = x
    xn = L.rmsnorm(bp["norm"], x, cfg.norm_eps)
    zxbcdt = L.dense(bp["in_proj"], xn)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * n]
    dt_raw = zxbcdt[..., -h:]

    xbc, new_tail = _causal_conv(xbc, bp["conv_w"],
                                 None if state is None else state["conv"])
    xs = xbc[..., :d_inner].reshape(b, s, h, p_dim)
    b_mat = xbc[..., d_inner:d_inner + n]
    c_mat = xbc[..., d_inner + n:]
    # jax.nn.softplus has no threshold; torch's returns x above 20, where
    # log1p(exp(-x)) < 2.1e-9 is below half an f32 ulp of x: the two agree
    dt = F.softplus(dt_raw.to(torch.float32) + bp["dt_bias"][None, None])
    a = -torch.exp(bp["a_log"])

    if state is None:
        chunk = min(cfg.ssm.chunk, s)
        if s % chunk != 0:
            chunk = s
        y, ssd_state = kops.ssd(xs, dt, a, b_mat, c_mat, chunk=chunk,
                                want_state=want_state)
    else:
        y_t, ssd_state = kops.ssd_decode_step(
            state["ssd"], xs[:, 0], dt[:, 0], a, b_mat[:, 0], c_mat[:, 0])
        y = y_t[:, None]
    new_state = ({"ssd": ssd_state, "conv": new_tail}
                 if state is not None or want_state else None)

    y = y.reshape(b, s, d_inner)
    y = L.rmsnorm(bp["gate_norm"],
                  y * F.silu(z.to(torch.float32)).to(y.dtype), cfg.norm_eps)
    # the reference's row-parallel `dense_rp` is `dense` on one device
    return res + L.dense(bp["out_proj"], y), new_state


def forward(params: Dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] → hidden [B, S, D]."""
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = _block_apply(L.layer_slice(params["blocks"], i), x, cfg)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def token_nll(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row mean NLL [B] of tokens/targets/mask [B, S]."""
    return L.cross_entropy(L.logits(params, forward(params, cfg, tokens)),
                           targets, mask)


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    """batch tokens/targets/mask: [K, b, S] → per-client losses [K]."""
    return L.loss_per_client(forward, params, cfg, batch)



# ---------------------------------------------------------------------------
# Serving — O(1) state
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda") -> Dict:
    """Zero decode state on `device`: {"ssd": [L, B, H, P, N] (f32 whatever
    `dtype`), "conv": [L, B, d_conv − 1, d_inner + 2N]}."""
    d_inner, h, n, d_conv, p_dim = _dims(cfg)
    lcount = cfg.n_layers
    return {
        "ssd": torch.zeros((lcount, batch, h, p_dim, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((lcount, batch, d_conv - 1, d_inner + 2 * n),
                            dtype=dtype, device=device),
    }


def _write_state(state: Dict, i: int, new: Dict) -> None:
    """Layer i's new state into the stacked buffers, in place."""
    for name, t in new.items():
        state[name][i].copy_(t)


def decode_step(params: Dict, cfg: ModelConfig, state: Dict,
                tokens: torch.Tensor, cache_pos=None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens [B, 1] → (logits [B, 1, V], state). The state is updated in
    place and returned; `cache_pos` is unused (the state is
    position-free)."""
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        layer_state = {name: t[i] for name, t in state.items()}
        x, new = _block_apply(L.layer_slice(params["blocks"], i), x, cfg,
                              state=layer_state)
        _write_state(state, i, new)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.logits(params, x), state


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
    """The full forward while collecting each layer's final SSD state
    (the kernel's stateful entry) and conv tail: (last-position logits
    [B, 1, V], state)."""
    x = L.embed(params["embed"], tokens)
    state = init_state(cfg, tokens.shape[0], dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, new = _block_apply(L.layer_slice(params["blocks"], i), x, cfg,
                              want_state=True)
        _write_state(state, i, new)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.logits(params, x[:, -1:]), state
