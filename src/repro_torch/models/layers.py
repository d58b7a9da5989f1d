"""Building blocks of the dense transformer, ported from
`repro.models.layers`.

Params are nested dicts of tensors; scan-stacked layer leaves carry a
leading L dim (the forward slices one layer's views per step). Compute is
f32; attention goes through `kernels.ops.attention` (the CUDA kernel on
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


def init_from_specs(specs: dict, key: torch.Tensor, device) -> dict:
    """f32 params from a family's `param_specs` — nested dicts and lists of
    (shape, init) per leaf, init a `Normal`, None for ones or a `Fill` —
    drawn from the root `key` (a `prng` key) as the reference's init draws
    them, on `device` (on the meta device, shapes only: nothing is
    drawn)."""
    device = torch.device(device)
    key = key.to(device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, init = node
        if device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device=device)
        if init is None:
            return torch.ones(shape, dtype=torch.float32, device=device)
        if isinstance(init, Fill):
            return torch.full(shape, init.value, dtype=torch.float32,
                              device=device)
        k = key
        for n, i in init.path:
            k = prng.split(k, n)
            if i is not None:
                k = k[..., i, :]
        w = prng.normal(k, shape[k.dim() - 1:])
        return w / init.divisor if init.divisor is not None \
            else w * init.scale
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
    return torch.matmul(x.to(torch.float32), p["w"].to(torch.float32).t())


def logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [.., V] of final hidden states [.., D]: the lm head, or
    the tied embedding."""
    return unembed(params.get("lm_head", params["embed"]), x)


def loss_per_client(forward, params: dict, cfg: ModelConfig,
                    batch: dict) -> torch.Tensor:
    """Per-client mean NLL of a language model: batch tokens/targets/mask
    [K, b, S] → [K]; `forward(params, cfg, tokens)` gives the final hidden
    states and `logits` makes the logits."""
    k, b, _ = batch["tokens"].shape
    flat = lambda a: a.reshape((k * b,) + tuple(a.shape[2:]))  # noqa: E731
    x = forward(params, cfg, flat(batch["tokens"]))
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
               cache_pos: Optional[int] = None) -> torch.Tensor:
    """Self-attention: x [B, S, D] → [B, S, D].

    Without a cache the whole sequence attends through `kops.attention`
    (the kernel on the card). With `kv_cache` ({"k","v": [B, S_max, Hkv,
    hd]}, one layer's views of the stacked cache) the S new tokens enter
    at `cache_pos` (a host int): k is roped at cache_pos + arange(S), k and
    v are written into the cache in place (the reference donates its
    cache; no copy of the whole buffer is made here either), and the
    output is `decode_attend` over the whole buffer."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    q = dense({"w": p["wq"]}, x).reshape(b, s, hq, hd)
    k = dense({"w": p["wk"]}, x).reshape(b, s, hkv, hd)
    v = dense({"w": p["wv"]}, x).reshape(b, s, hkv, hd)
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta)
    if kv_cache is not None:
        kpos = cache_pos + torch.arange(s, device=x.device)
        k = rope(k.transpose(1, 2), kpos, cfg.rope_theta).transpose(1, 2)
        kv_cache["k"][:, cache_pos:cache_pos + s] = k
        kv_cache["v"][:, cache_pos:cache_pos + s] = v
        out = decode_attend(q.transpose(1, 2), kv_cache["k"], kv_cache["v"],
                            kpos, window=window)
        return dense({"w": p["wo"]}, out.reshape(b, s, hq * hd))
    k = rope(k.transpose(1, 2), positions, cfg.rope_theta)
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
