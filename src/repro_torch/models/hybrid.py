"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks and local
attention, ported from `repro.models.hybrid`: the training forward and
the serve path (an O(1) decode state: the RG-LRU hidden and conv tail of
each recurrent block, a rolling `local_window`-deep KV buffer of each
attention block).

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
from typing import Dict, Optional, Tuple

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

def _hybrid_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, no activation. x: [B, S, C]; w: [W, C];
    tail: [B, W−1, C] carried state (zeros if None) → (y, new tail)."""
    b, s, c = x.shape
    wlen = w.shape[0]
    if tail is None:
        tail = x.new_zeros((b, wlen - 1, c))
    xp = torch.cat([tail, x], dim=1)
    # the reference's Python sum: 0 + term 0 + term 1 + ...
    y = sum(xp[:, i:i + s] * w[i][None, None].to(x.dtype)
            for i in range(wlen))
    new_tail = xp[:, -(wlen - 1):] if wlen > 1 else tail
    return y, new_tail


def _rglru_mix(bp: Dict, xn: torch.Tensor, *, state: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """RG-LRU temporal mixing. xn: [B, S, D_model] (already normed); with
    `state` ({"lru": [B, W], "conv": [B, cw−1, W]}) the recurrence starts
    from its hidden and the conv from its tail, and the new state is
    returned (None without)."""
    xw = L.dense(bp["lin_x"], xn)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(L.dense(bp["lin_gate"], xn).to(torch.float32),
                  approximate="tanh").to(xw.dtype)
    xw, new_tail = _hybrid_conv(xw, bp["conv_w"],
                                None if state is None else state["conv"])

    r = torch.sigmoid(L.dense(bp["w_rec_gate"], xw).to(torch.float32))
    i = torch.sigmoid(L.dense(bp["w_in_gate"], xw).to(torch.float32))
    # jax.nn.softplus has no threshold; torch's returns x above 20, where
    # log1p(exp(-x)) < 2.1e-9 is below half an f32 ulp of x: the two agree
    log_a = -_LRU_C * F.softplus(bp["lambda_p"])[None, None] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    drive = (beta * i * xw.to(torch.float32)).to(xw.dtype)

    h0 = None if state is None else state["lru"]
    hs, h_last = kops.linear_recurrence(a.to(xw.dtype), drive, h0)
    new_state = None if state is None else {"lru": h_last, "conv": new_tail}
    # the reference's row-parallel `dense_rp` is `dense` on one device
    return L.dense(bp["out"], gate * hs), new_state


def _rglru_block_apply(bp: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                       state: Optional[Dict] = None
                       ) -> Tuple[torch.Tensor, Optional[Dict]]:
    mix, new_state = _rglru_mix(bp, L.rmsnorm(bp["norm"], x, cfg.norm_eps),
                                state=state)
    x = x + mix
    x = x + L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], x, cfg.norm_eps))
    return x, new_state


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
        x, _ = _rglru_block_apply(gp["r1"], x, cfg)
        x, _ = _rglru_block_apply(gp["r2"], x, cfg)
        x = _attn_block_apply(gp["a"], x, positions, cfg)
    for bp in params["tail"]:
        x, _ = _rglru_block_apply(bp, x, cfg)
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
# Serving — O(1) state (rolling window for attention blocks)
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda") -> Dict:
    """Zero decode state on `device`: {"r1", "r2": {"lru": [G, B, W],
    "conv": [G, B, cw−1, W]}, "attn": {"k", "v": [G, B, window, Hkv, hd]},
    "tail": {"lru", "conv"} with max(tail, 1) rows} for G rra groups."""
    w = cfg.hybrid.lru_width or cfg.d_model
    cw = cfg.hybrid.conv1d_width
    win = cfg.hybrid.local_window
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    n_groups, tail = _group_counts(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def rec_state(n):
        return {"lru": zeros(n, batch, w), "conv": zeros(n, batch, cw - 1, w)}

    return {"r1": rec_state(n_groups), "r2": rec_state(n_groups),
            "attn": {"k": zeros(n_groups, batch, win, hkv, hd),
                     "v": zeros(n_groups, batch, win, hkv, hd)},
            "tail": rec_state(max(tail, 1))}


def _rec_step(bp: Dict, x: torch.Tensor, cfg: ModelConfig, rec: Dict,
              i: int) -> torch.Tensor:
    """A recurrent block on row i of a stacked {"lru", "conv"} state,
    whose new values are written back in place."""
    x, new = _rglru_block_apply(bp, x, cfg, state={k: t[i] for k, t in
                                                   rec.items()})
    for name, t in new.items():
        rec[name][i].copy_(t)
    return x


def decode_step(params: Dict, cfg: ModelConfig, state: Dict,
                tokens: torch.Tensor, cache_pos: int
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens [B, 1] at `cache_pos` (a host int) → (logits [B, 1, V],
    state); the rolling attention cache writes slot cache_pos mod window.
    The state is updated in place and returned."""
    x = L.embed(params["embed"], tokens)
    positions = cache_pos + torch.arange(tokens.shape[1], device=x.device)
    n_groups, _ = _group_counts(cfg)
    for g in range(n_groups):
        gp = L.layer_slice(params["groups"], g)
        x = _rec_step(gp["r1"], x, cfg, state["r1"], g)
        x = _rec_step(gp["r2"], x, cfg, state["r2"], g)
        x = _attn_rolling(gp["a"], x, positions, cfg,
                          {k: t[g] for k, t in state["attn"].items()},
                          cache_pos)
    for i, bp in enumerate(params["tail"]):
        x = _rec_step(bp, x, cfg, state["tail"], i)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.logits(params, x), state


def _attn_rolling(bp: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, kv: Dict, cache_pos: int
                  ) -> torch.Tensor:
    """Local attention of one new token against a rolling [B, W, Hkv, hd]
    buffer (one group's views, written in place at slot cache_pos mod W).
    Slot i holds position cache_pos − ((slot − i) mod W); it counts if that
    position is in [0, cache_pos] and inside the window. Plain f32 as in
    the reference, with its −1e30 score for the rest."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    win = cfg.hybrid.local_window
    h = L.rmsnorm(bp["norm"], x, cfg.norm_eps)
    q = L.dense({"w": bp["attn"]["wq"]}, h).reshape(b, s, hq, hd)
    k = L.dense({"w": bp["attn"]["wk"]}, h).reshape(b, s, hkv, hd)
    v = L.dense({"w": bp["attn"]["wv"]}, h).reshape(b, s, hkv, hd)
    q = L.rope(q.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    k = L.rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)

    slot = cache_pos % win
    kv["k"][:, slot:slot + s] = k
    kv["v"][:, slot:slot + s] = v
    slot_pos = cache_pos - torch.remainder(
        slot - torch.arange(win, device=x.device), win)
    valid = (slot_pos >= 0) & (slot_pos <= cache_pos) \
        & (slot_pos > cache_pos - win)

    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, hd).to(torch.float32) / (hd ** 0.5)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, kv["k"].to(torch.float32))
    scores = torch.where(valid, scores, torch.full((), -1e30,
                                                   device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, kv["v"].to(torch.float32))
    out = out.reshape(b, s, hq * hd).to(x.dtype)
    x = x + L.dense({"w": bp["attn"]["wo"]}, out)
    return x + L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], x, cfg.norm_eps))


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
    """The full forward's last logits [B, 1, V] and a zero state, as the
    reference's prefill returns (`repro.models.hybrid.prefill`: its
    docstring leaves priming the recurrent and window state to
    production). Decoding after it does not see the prompt in the
    recurrent or rolling-attention state; the port follows the reference
    (ROADMAP, findings of the reference)."""
    x = forward(params, cfg, tokens)
    state = init_state(cfg, tokens.shape[0], dtype=params["embed"]["w"].dtype,
                       device=x.device)
    return L.logits(params, x[:, -1:]), state
