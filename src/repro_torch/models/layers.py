"""Building blocks of the dense transformer, ported from
`repro.models.layers`.

Params are nested dicts of tensors; scan-stacked layer leaves carry a
leading L dim (the forward slices one layer's views per step). Compute
is in the params' dtype (f32, or bf16 for the dense family) with f32
where the reference has it: matmuls accumulate in f32 (`torch.matmul` on
bf16 operands, cuBLAS's f32 accumulation on the card), and norms, rope,
softmax, SwiGLU's product and the logits are f32; attention goes through `kernels.ops.attention` (the CUDA kernel on
the card, the plain version on the CPU). The projections stay
`torch.matmul`, as `repro` leaves them to XLA — except on leaves tagged by
the fused dual forward (`kops.PerturbedParam`), which go to the fused
kernels: `dense` to `perturbed_matmul`, `embed` to `perturbed_gather`,
`unembed` to `perturbed_unembed`, and `rmsnorm` resolves its [D] gain.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class Fill:
    """init tag of a constant-filled leaf in a family's `param_specs`"""
    value: float


ZEROS = Fill(0.0)


@dataclass(frozen=True)
class Normal:
    """init tag of a normal leaf in a family's `param_specs`: drawn with
    `prng.normal` from the key at `path` below the family's root key, then
    times `scale`, or divided by `divisor` where the reference divides (the
    two can differ by an ulp). Each step (n, i) of the path is
    split(key, n)[i]; (n, None) keeps all n keys of the split, a leading
    dim of the leaf (the reference's vmap over layer keys)."""
    path: Tuple[Tuple[int, Optional[int]], ...]
    scale: float = 1.0
    divisor: Optional[float] = None


def init_from_specs(specs: dict, key: torch.Tensor, device,
                    dtype=torch.float32) -> dict:
    """Params in `dtype` from a family's `param_specs` — nested dicts and
    lists of (shape, init) per leaf, init a `Normal`, None for ones or a
    `Fill` — drawn from the root `key` (a `prng` key) as the reference's
    init draws them, on `device` (on the meta device, shapes only: nothing
    is drawn). A normal leaf is drawn and scaled in f32 and then cast,
    rounding to nearest even (the reference's `_init`); ones and fills are
    made in `dtype`."""
    device = torch.device(device)
    key = key.to(device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, init = node
        if device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
        if init is None:
            return torch.ones(shape, dtype=dtype, device=device)
        if isinstance(init, Fill):
            return torch.full(shape, init.value, dtype=dtype, device=device)
        k = key
        for n, i in init.path:
            k = prng.split(k, n)
            if i is not None:
                k = k[..., i, :]
        w = prng.normal(k, shape[k.dim() - 1:])
        w = w / init.divisor if init.divisor is not None \
            else w * init.scale
        return w.to(dtype)
    return build(specs)


def sub(path: tuple, n: int, i: Optional[int]) -> tuple:
    """`path` extended by one split step (n, i)."""
    return path + ((n, i),)


# the reference's init helpers as specs: `path` is the key the helper gets,
# `lead` the stacked dims of a vmapped init

def dense_specs(path: tuple, lead: tuple, d_in: int, d_out: int) -> dict:
    """`dense_init`: one draw of [d_in, d_out] at 1/√d_in."""
    return {"w": (lead + (d_in, d_out), Normal(path, 1.0 / math.sqrt(d_in)))}


def embed_specs(path: tuple, vocab: int, d: int) -> dict:
    """`embed_init`: one draw of [vocab, d] at 0.02."""
    return {"w": ((vocab, d), Normal(path, 0.02))}


def norm_specs(lead: tuple, d: int) -> dict:
    """`rmsnorm_init`: ones."""
    return {"g": (lead + (d,), None)}


def gqa_specs(path: tuple, lead: tuple, cfg: ModelConfig) -> dict:
    """`gqa_init`: split(key, 4) → wq, wk, wv, wo."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    w = lambda i, shape: (lead + shape, Normal(  # noqa: E731
        sub(path, 4, i), 1.0 / math.sqrt(shape[0])))
    return {"wq": w(0, (d, hq * hd)), "wk": w(1, (d, hkv * hd)),
            "wv": w(2, (d, hkv * hd)), "wo": w(3, (hq * hd, d))}


def mlp_specs(path: tuple, lead: tuple, d: int, d_ff: int) -> dict:
    """`mlp_init`: split(key, 3) → wi, wg, wd."""
    w = lambda i, shape: (lead + shape, Normal(  # noqa: E731
        sub(path, 3, i), 1.0 / math.sqrt(shape[0])))
    return {"wi": w(0, (d, d_ff)), "wg": w(1, (d, d_ff)),
            "wd": w(2, (d_ff, d))}


def layer_slice(blocks: dict, i: int) -> dict:
    """Views of layer i of the scan-stacked block leaves. A tagged leaf
    (`kops.PerturbedParam`) slices into layer i's tag, its counters
    continuing the whole leaf's stream."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ w [D, F]."""
    if isinstance(p["w"], kops.PerturbedParam):
        # fused ZO dual forward: x @ (w + εz), z regenerated in-kernel
        return kops.perturbed_matmul(x, p["w"])
    return torch.matmul(x, p["w"])


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = kops.resolve(p["g"])   # [D]-sized transient when tagged (fused ZO)
    return (xf * scale * g.to(torch.float32)).to(x.dtype)


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(p["w"], kops.PerturbedParam):
        # fused ZO: z drawn only for the gathered rows, never for the table
        return kops.perturbed_gather(p["w"], tokens)
    # the rows p["w"][tokens]; `embedding`'s backward sums a row's grads in
    # one deterministic order on both devices (indexing's `index_put_` with
    # accumulate does not on the CPU), so FO runs repeat bitwise
    return torch.nn.functional.embedding(tokens, p["w"])


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """lm head: [.., D] @ [V, D]ᵀ → [.., V] f32 logits."""
    if isinstance(p["w"], kops.PerturbedParam):
        return kops.perturbed_unembed(x, p["w"])
    return kops.unembed_matmul(x, p["w"])


def head(params: dict) -> dict:
    """The lm head, or the tied embedding (the encoder-decoder's
    `dec_embed`)."""
    for name in ("lm_head", "embed", "dec_embed"):
        if name in params:
            return params[name]
    raise KeyError("params hold no lm_head, embed or dec_embed")


def logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [.., V] of final hidden states [.., D]: the lm head, or
    the tied embedding."""
    return unembed(head(params), x)


def loss_per_client(forward, params: dict, cfg: ModelConfig,
                    batch: dict) -> torch.Tensor:
    """Per-client mean NLL of a language model: batch tokens/targets/mask
    [K, b, S] (and the stub frontend's prefix_embeds [K, b, P, D] when
    present, passed on to the forward) → [K]; `forward(params, cfg,
    tokens)` gives the final hidden states, of which the last S (the text
    positions) are scored, and `logits` makes the logits."""
    k, b, s = batch["tokens"].shape
    flat = lambda a: a.reshape((k * b,) + tuple(a.shape[2:]))  # noqa: E731
    extra = ({"prefix_embeds": flat(batch["prefix_embeds"])}
             if "prefix_embeds" in batch else {})
    x = forward(params, cfg, flat(batch["tokens"]), **extra)[:, -s:]
    nll = cross_entropy(logits(params, x), flat(batch["targets"]),
                        flat(batch["mask"]))
    return torch.mean(nll.reshape(k, b), dim=-1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Per-row mean NLL: logits [.., S, V], targets/mask [.., S] → [..]."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = (lse - tgt) * mask
    return torch.sum(nll, dim=-1) / torch.clamp_min(torch.sum(mask, dim=-1),
                                                    1.0)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, D_head(even)]; positions: [S]."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions.to(torch.float32)[..., None] * freqs      # [S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def gqa_attend(p: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, *, causal: bool = True,
               window: Optional[int] = None,
               kv_cache: Optional[dict] = None,
               cache_pos: Optional[int] = None,
               kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of x [B, S, D] → [B, S, D]: self-attention, or with
    `kv_x` [B, T, D] cross-attention (k and v projected from kv_x, the
    encoder-decoder's). q and k are roped at `positions` when `causal` or
    for self-attention, as the reference's; a non-causal cross-attention
    is not roped.

    Without a cache the whole sequence attends through `kops.attention`
    (the kernel on the card). With `kv_cache` ({"k","v": [B, S_max, Hkv,
    hd]}, one layer's views of the stacked cache; self-attention only)
    the S new tokens enter at `cache_pos` (a host int): k is roped at
    cache_pos + arange(S), k and v are written into the cache in place
    (the reference donates its cache; no copy of the whole buffer is made
    here either), and the output is `decode_attend` over the whole
    buffer."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    src = x if kv_x is None else kv_x
    t = src.shape[1]
    q = dense({"w": p["wq"]}, x).reshape(b, s, hq, hd).transpose(1, 2)
    k = dense({"w": p["wk"]}, src).reshape(b, t, hkv, hd)
    v = dense({"w": p["wv"]}, src).reshape(b, t, hkv, hd)
    roped = causal or kv_x is None
    if roped:
        q = rope(q, positions, cfg.rope_theta)
    if kv_cache is not None:
        kpos = cache_pos + torch.arange(s, device=x.device)
        k = rope(k.transpose(1, 2), kpos, cfg.rope_theta).transpose(1, 2)
        kv_cache["k"][:, cache_pos:cache_pos + s] = k
        kv_cache["v"][:, cache_pos:cache_pos + s] = v
        out = decode_attend(q.transpose(1, 2), kv_cache["k"], kv_cache["v"],
                            kpos, window=window)
        return dense({"w": p["wo"]}, out.reshape(b, s, hq * hd))
    k = k.transpose(1, 2)
    if roped:
        k = rope(k, positions, cfg.rope_theta)
    out = kops.attention(q.contiguous(), k.contiguous(),
                         v.transpose(1, 2).contiguous(), causal=causal,
                         window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return dense({"w": p["wo"]}, out)


def decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  q_abs: torch.Tensor,
                  window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a KV-cache buffer with absolute positions,
    plain f32 as in the reference (no Pallas kernel there either).

    q: [B, S, Hq, hd]; ck/cv: [B, S_max, Hkv, hd]; q_abs: [S] absolute
    positions of the query tokens. Slots past q_abs (stale or unwritten)
    and, with a window, those at or before q_abs − window get the
    reference's −1e30 score. Linear in S_max (no S² transient)."""
    b, s, hq, hd = q.shape
    hkv = ck.shape[2]
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, hd).to(torch.float32) / math.sqrt(hd)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, ck.to(torch.float32))
    t_pos = torch.arange(ck.shape[1], device=q.device)
    mask = t_pos[None, :] <= q_abs[:, None]
    if window is not None:
        mask &= t_pos[None, :] > q_abs[:, None] - window
    scores = torch.where(mask[None, None, None], scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, cv.to(torch.float32))
    return out.reshape(b, s, hq, hd).to(q.dtype)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SwiGLU: (silu(x wg) ⊙ x wi) wd."""
    h = torch.nn.functional.silu(dense({"w": p["wg"]}, x).to(torch.float32)) \
        * dense({"w": p["wi"]}, x).to(torch.float32)
    return dense({"w": p["wd"]}, h.to(x.dtype))


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------

def mla_specs(path: tuple, lead: tuple, cfg: ModelConfig) -> dict:
    """`mla_init`: split(key, 6) → wkv_a ks[0], wkv_b ks[1], wo ks[2], and
    wq_a ks[3], wq_b ks[4] (q_lora_rank > 0) or wq ks[5]."""
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    w = lambda i, shape: (lead + shape, Normal(  # noqa: E731
        sub(path, 6, i), 1.0 / math.sqrt(shape[0])))
    p = {"wkv_a": w(0, (d, m.kv_lora_rank + m.qk_rope_head_dim)),
         "kv_norm": norm_specs(lead, m.kv_lora_rank),
         "wkv_b": w(1, (m.kv_lora_rank, h * (m.qk_nope_head_dim
                                             + m.v_head_dim))),
         "wo": w(2, (h * m.v_head_dim, d))}
    if m.q_lora_rank > 0:
        p["wq_a"] = w(3, (d, m.q_lora_rank))
        p["q_norm"] = norm_specs(lead, m.q_lora_rank)
        p["wq_b"] = w(4, (m.q_lora_rank, h * qd))
    else:
        p["wq"] = w(5, (d, h * qd))
    return p


def _mla_q(p: dict, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_nope [B, S, H, dn] and the roped q_rope [B, S, H, dr]."""
    b, s, _ = x.shape
    m = cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    if "wq_a" in p:
        ql = rmsnorm(p["q_norm"], dense({"w": p["wq_a"]}, x), cfg.norm_eps)
        q = dense({"w": p["wq_b"]}, ql)
    else:
        q = dense({"w": p["wq"]}, x)
    q = q.reshape(b, s, cfg.n_heads, qd)
    q_rope = rope(q[..., m.qk_nope_head_dim:].transpose(1, 2), positions,
                  cfg.rope_theta).transpose(1, 2)
    return q[..., :m.qk_nope_head_dim], q_rope


def mla_latent(p: dict, x: torch.Tensor, kpos: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent a token caches: the normed ckv [B, S, R] and its roped
    key krope [B, S, dr] at positions kpos."""
    m = cfg.mla
    kv = dense({"w": p["wkv_a"]}, x)
    ckv = rmsnorm(p["kv_norm"], kv[..., :m.kv_lora_rank], cfg.norm_eps)
    krope = rope(kv[..., m.kv_lora_rank:][:, None], kpos,
                 cfg.rope_theta)[:, 0]
    return ckv, krope


def mla_attend(p: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, *, kv_cache: Optional[dict] = None,
               cache_pos: Optional[int] = None) -> torch.Tensor:
    """MLA with the compressed latent cache: x [B, S, D] → [B, S, D].

    Train and prefill (no cache): k and v are expanded per head from the
    latent, krope broadcast over the heads, v zero-padded from v_head_dim
    up to the q·k dim, and `kops.attention` runs with the scale of the
    unpadded q·k dim (1/√(dn + dr)). Decode (`kv_cache` {"ckv": [B, S_max,
    R], "krope": [B, S_max, dr]}, one layer's views, written in place at
    `cache_pos`, a host int): the absorbed form, attention in the latent
    space, plain f32 einsums as in the reference (no kernel there), with
    its −1e30 fill over the whole cache length."""
    b, s, _ = x.shape
    m = cfg.mla
    h, dn, dv = cfg.n_heads, m.qk_nope_head_dim, m.v_head_dim
    qd = dn + m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(qd)
    kpos = positions if kv_cache is None else (
        cache_pos + torch.arange(s, device=x.device))
    ckv, krope = mla_latent(p, x, kpos, cfg)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    # fused ZO: a per-layer transient drawn by seeded_axpy
    wkv_b = kops.resolve(p["wkv_b"]).reshape(m.kv_lora_rank, h, dn + dv)
    wk, wv = wkv_b[..., :dn], wkv_b[..., dn:]            # [R, H, dn|dv]
    f32 = torch.float32

    if kv_cache is not None:
        kv_cache["ckv"][:, cache_pos:cache_pos + s] = ckv
        kv_cache["krope"][:, cache_pos:cache_pos + s] = krope
        cckv = kv_cache["ckv"].to(f32)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.to(f32), wk.to(f32))
        s_lat = torch.einsum("bshr,btr->bhst", q_lat, cckv)
        s_rope = torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                              kv_cache["krope"].to(f32))
        scores = (s_lat + s_rope) * scale
        t_pos = torch.arange(cckv.shape[1], device=x.device)
        mask = t_pos[None, :] <= kpos[:, None]
        scores = torch.where(mask[None, None], scores,
                             torch.full((), -1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", probs, cckv)
        out = torch.einsum("bshr,rhv->bshv", o_lat, wv.to(f32))
        return dense({"w": p["wo"]}, out.reshape(b, s, h * dv).to(x.dtype))

    k_nope = torch.einsum("btr,rhn->bthn", ckv, wk)
    v = torch.einsum("btr,rhv->bthv", ckv, wv)
    k_full = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    v_pad = torch.nn.functional.pad(v, (0, qd - dv))
    out = kops.attention(q_full.transpose(1, 2).contiguous(),
                         k_full.transpose(1, 2).contiguous(),
                         v_pad.transpose(1, 2).contiguous(), causal=True,
                         scale=scale)
    out = out.transpose(1, 2)[..., :dv].reshape(b, s, h * dv)
    return dense({"w": p["wo"]}, out)


# ---------------------------------------------------------------------------
# MoE — capacity-grouped top-k experts
# ---------------------------------------------------------------------------

def moe_specs(path: tuple, lead: tuple, cfg: ModelConfig) -> dict:
    """`moe_init`: split(key, 5) → router ks[0], the expert banks we_i,
    we_g, we_d ks[1..3], and the shared experts' `mlp_init` at ks[4] of
    width d_expert · n_shared_experts."""
    d, m = cfg.d_model, cfg.moe
    w = lambda i, shape, fan_in: (lead + shape, Normal(  # noqa: E731
        sub(path, 5, i), 1.0 / math.sqrt(fan_in)))
    p = {"router": w(0, (d, m.n_experts), d),
         "we_i": w(1, (m.n_experts, d, m.d_expert), d),
         "we_g": w(2, (m.n_experts, d, m.d_expert), d),
         "we_d": w(3, (m.n_experts, m.d_expert, d), m.d_expert)}
    if m.n_shared_experts > 0:
        p["shared"] = mlp_specs(sub(path, 5, 4), lead, d,
                                m.d_expert * m.n_shared_experts)
    return p


def _moe_rows(banks: dict, x: torch.Tensor, logits: torch.Tensor, k: int,
              cap: int) -> torch.Tensor:
    """The reference's `_moe_row` for every batch row of one dispatch
    group: x [B, T, D], router logits [B, T, E] f32, the expert banks
    `banks` (we_i, we_g, we_d) → [B, T, D].

    Dispatch: (token, slot) pairs take queue positions in flat order and
    those at or past `cap` are dropped. The reference scatters every
    dropped pair onto expert 0's last slot with token 0 and gate 0, and
    on its scatter the last write wins: so when a dropped pair follows
    the pair that filled that slot, that pair is dropped too. Here no
    scatter has a duplicate index (the card's has no defined winner):
    served pairs are written, dropped ones go to slots of their own past
    the table, and that overwrite is applied explicitly. Combine: each
    token sums its served slots in ascending expert order (the order of
    the reference's flat scatter-add), never by atomics, so runs repeat
    bitwise. No host synchronization: a CUDA graph captures it."""
    b, t, d = x.shape
    e = logits.shape[-1]
    n = t * k
    dev = x.device
    # top-k in descending order, the lower index first on ties
    # (`jax.lax.top_k`)
    gates, top = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(gates[..., :k], dim=-1).reshape(b, n)
    flat_e = top[..., :k].reshape(b, n)                       # [B, T·k]
    onehot = (flat_e[..., None]
              == torch.arange(e, device=dev)).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - 1, 2,
                       flat_e[..., None])[..., 0].long()
    keep = pos < cap
    idx = torch.arange(n, device=dev)
    last_slot = keep & (flat_e == 0) & (pos == cap - 1)
    filled_at = torch.amax(torch.where(last_slot, idx, -1), dim=1)
    dropped_at = torch.amax(torch.where(keep, -1, idx), dim=1)
    served = keep & ~(last_slot & (dropped_at > filled_at)[:, None])
    slot = flat_e * cap + pos
    where = torch.where(served, slot, e * cap + idx)
    tok = torch.zeros((b, e * cap + n), dtype=torch.long, device=dev)
    tok.scatter_(1, where, (idx // k).expand(b, n))
    gate = torch.zeros((b, e * cap + n), dtype=torch.float32, device=dev)
    gate.scatter_(1, where, gates)
    tok, gate = tok[:, :e * cap], gate[:, :e * cap]

    xe = torch.gather(x, 1, tok[..., None].expand(b, e * cap, d))
    xe = xe.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    hi = torch.bmm(xe, banks["we_i"])                         # [E, B·C, F]
    hg = torch.bmm(xe, banks["we_g"])
    hh = (torch.nn.functional.silu(hg.to(torch.float32))
          * hi.to(torch.float32)).to(x.dtype)
    ye = torch.bmm(hh, banks["we_d"]).to(torch.float32)
    ye = ye.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    ye = ye * gate[..., None]

    order = torch.argsort(flat_e.reshape(b, t, k), dim=-1)
    slot = torch.gather(slot.reshape(b, t, k), 2, order)
    served = torch.gather(served.reshape(b, t, k), 2, order)
    picked = torch.gather(
        ye, 1, torch.where(served, slot, 0).reshape(b, n, 1).expand(
            b, n, d)).reshape(b, t, k, d)
    out = torch.zeros((b, t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + torch.where(served[..., j, None], picked[:, :, j], 0.0)
    return out.to(x.dtype)


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunked capacity-grouped top-k MoE, as the reference's: x [B, S, D]
    → [B, S, D]. The sequence goes in dispatch groups of
    chunk = min(moe.chunk, S) tokens (one group of S when chunk does not
    divide S), each expert taking cap = max(⌈k·chunk·cf / E⌉, 1) tokens
    of a group, dispatched per batch row; the router is one product over
    all tokens. The expert products are batched matmuls over the expert
    banks, as in the reference; under fused ZO each bank resolves to a
    per-layer transient, once a layer (the reference resolves it in every
    group). Its `_moe_tiny_tokens` runs only on a mesh with a `model` axis
    larger than 1 (ROADMAP A11)."""
    b, s, d = x.shape
    m = cfg.moe
    e, k = m.n_experts, m.n_experts_per_tok
    chunk = min(m.chunk, s) if m.chunk > 0 else s
    if s % chunk != 0:
        chunk = s
    cap = max(int(math.ceil(k * chunk * m.capacity_factor / e)), 1)
    logits = dense({"w": p["router"]}, x).to(torch.float32)
    banks = {n: kops.resolve(p[n]) for n in ("we_i", "we_g", "we_d")}
    out = torch.cat([_moe_rows(banks, x[:, c:c + chunk],
                               logits[:, c:c + chunk], k, cap)
                     for c in range(0, s, chunk)], dim=1)
    if "shared" in p:
        out = out + mlp(p["shared"], x)
    return out
