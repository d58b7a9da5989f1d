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
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class Fill:
    """init tag of a constant-filled leaf in a family's `param_specs`"""
    value: float


ZEROS = Fill(0.0)


def init_from_specs(specs: dict, generator: torch.Generator, device) -> dict:
    """Random f32 params from a family's `param_specs` — nested dicts and
    lists of (shape, init) per leaf, init a normal std, None for ones or a
    `Fill` — with the reference's scales (not its values: torch's
    generator is not threefry). Normal leaves draw in flattening order."""
    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, std = node
        if std is None:
            return torch.ones(shape, dtype=torch.float32, device=device)
        if isinstance(std, Fill):
            return torch.full(shape, std.value, dtype=torch.float32,
                              device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(std)
    return build(specs)


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
    return p["w"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """lm head: [.., D] @ [V, D]ᵀ → [.., V] f32 logits."""
    if isinstance(p["w"], kops.PerturbedParam):
        return kops.perturbed_unembed(x, p["w"])
    return torch.matmul(x.to(torch.float32), p["w"].to(torch.float32).t())


def loss_per_client(forward, params: dict, cfg: ModelConfig,
                    batch: dict) -> torch.Tensor:
    """Per-client mean NLL of a language model: batch tokens/targets/mask
    [K, b, S] → [K]; `forward(params, cfg, tokens)` gives the final hidden
    states and the lm head (or the tied embedding) makes the logits."""
    k, b, _ = batch["tokens"].shape
    flat = lambda a: a.reshape((k * b,) + tuple(a.shape[2:]))  # noqa: E731
    x = forward(params, cfg, flat(batch["tokens"]))
    head = params.get("lm_head", params["embed"])
    nll = cross_entropy(unembed(head, x), flat(batch["targets"]),
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
               window: Optional[int] = None) -> torch.Tensor:
    """Self-attention without a KV cache: x [B, S, D] → [B, S, D]."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    q = dense({"w": p["wq"]}, x).reshape(b, s, hq, hd).transpose(1, 2)
    k = dense({"w": p["wk"]}, x).reshape(b, s, hkv, hd).transpose(1, 2)
    v = dense({"w": p["wv"]}, x).reshape(b, s, hkv, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return dense({"w": p["wo"]}, out)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SwiGLU: (silu(x wg) ⊙ x wi) wd."""
    h = torch.nn.functional.silu(dense({"w": p["wg"]}, x).to(torch.float32)) \
        * dense({"w": p["wi"]}, x).to(torch.float32)
    return dense({"w": p["wd"]}, h.to(x.dtype))
