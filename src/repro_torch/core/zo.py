"""Zeroth-order (SPSA / MeZO) seeded gradient estimation (paper Sec. IV-A),
ported from `repro.core.zo`.

A client needs only p_k = (F_k(w + μz) − F_k(w − μz)) / (2μ) (Eq. 7), and the
update is w ← w − η p̂ z (Algorithm 1, line 14). z is regenerated on demand
from the broadcast seed, leaf by leaf: leaf i of the parameter tree (in the
reference's sorted-key flattening, `flatten`) draws the counter-hash
stream seeded by `leaf_seed(seed, i)`.

`leaf_seed`, `perturb_seed` and `round_seed` are host integer functions.
What the update functions take is a direction's seed row: the `n_leaves`
leaf seeds of one perturbation direction, indexed in `flatten` order, as a
1-D int32 tensor on the leaves' device holding the uint32 bits (int32, not
int64, because the kernels read each element as a uint32 from device
memory). `seed_row` makes one from a direction seed, and the control trace
carries one per round and direction (`seed_table`, `ctl["leaf_seeds"]`),
so a round launches no kernel with a host seed and a captured CUDA graph
replays any round from its inputs.
"""
from __future__ import annotations

import functools
import itertools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.seeded_axpy import GOLDEN, MASK32, fmix32, mul32

Params = Dict


def flatten(params, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in JAX's flattening order (dicts by sorted key,
    lists by index, depth first) — the leaf index i that `leaf_seed` keys
    each stream by. Paths read `groups.a.norm.g`, `tail[0].conv_w`."""
    if isinstance(params, dict):
        items = ((f"{prefix}.{k}" if prefix else k, params[k])
                 for k in sorted(params))
    else:
        items = ((f"{prefix}[{i}]", v) for i, v in enumerate(params))
    out = []
    for path, v in items:
        if isinstance(v, (dict, list)):
            out.extend(flatten(v, path))
        else:
            out.append((path, v))
    return out


def leaf_seed(seed: int, leaf_idx: int) -> int:
    """Independent per-leaf stream seed: fmix32(seed · φ + leaf_idx)."""
    return fmix32(((int(seed) & MASK32) * GOLDEN + leaf_idx) & MASK32)


def round_seed(base_seed: int, t: int) -> int:
    """The seed the server broadcasts for round t."""
    return fmix32((int(base_seed) & MASK32)
                  ^ (((int(t) & MASK32) * 0x85EBCA6B) & MASK32))


def perturb_seed(round_seed_t: int, j: int) -> int:
    """Seed of perturbation direction j within a round."""
    return fmix32((int(round_seed_t) + ((GOLDEN * (j + 1)) & MASK32))
                  & MASK32)


def seed_table(base_seed: int, t0: int, t1: int, n_perturb: int,
               n_leaves: int) -> np.ndarray:
    """[R, n_perturb, n_leaves] uint32: leaf_seed(perturb_seed(round_seed(
    base_seed, t), j), i) for rounds t in [t0, t1), vectorized over int64
    arrays with the same uint32 arithmetic as the scalar functions."""
    t = np.arange(t0, t1, dtype=np.int64)
    rs = fmix32((int(base_seed) & MASK32) ^ mul32(t & MASK32, 0x85EBCA6B))
    return leaf_seed_table(rs, n_perturb, n_leaves)


def leaf_seed_table(round_seeds, n_perturb: int,
                    n_leaves: int) -> np.ndarray:
    """[R, n_perturb, n_leaves] uint32: leaf_seed(perturb_seed(s, j), i)
    for each round seed s of `round_seeds` [R] (the desync trace's lagged
    seeds take this path)."""
    rs = np.asarray(round_seeds, dtype=np.int64)[:, None, None] & MASK32
    j = np.arange(n_perturb, dtype=np.int64)[None, :, None]
    i = np.arange(n_leaves, dtype=np.int64)[None, None, :]
    ps = fmix32((rs + mul32(j + 1, GOLDEN)) & MASK32)
    return fmix32((mul32(ps, GOLDEN) + i) & MASK32).astype(np.uint32)


def seed_row(seed: int, n_leaves: int, device="cpu") -> torch.Tensor:
    """The seed row of direction seed `seed`: [n_leaves] int32 holding the
    uint32 bits of leaf_seed(seed, i)."""
    row = np.asarray([leaf_seed(seed, i) for i in range(n_leaves)],
                     dtype=np.uint32)
    return torch.from_numpy(row.view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _const(value: float, device: torch.device) -> torch.Tensor:
    # device-resident f32 scalars for the fixed scales (±μ, −2μ), made once
    return torch.tensor(value, dtype=torch.float32, device=device)


def _scale(scale, device: torch.device) -> torch.Tensor:
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device, dtype=torch.float32)
    return _const(float(scale), device)


def _map_leaves(fn, node, counter):
    """The tree with each leaf replaced by fn(i, leaf), i counting leaves in
    `flatten` order (dicts by sorted key, lists by index)."""
    if isinstance(node, dict):
        return {k: _map_leaves(fn, node[k], counter) for k in sorted(node)}
    if isinstance(node, list):
        return [_map_leaves(fn, v, counter) for v in node]
    return fn(next(counter), node)


def rebuild(params, leaves):
    """The tree of `params` with its leaves replaced by `leaves`, taken in
    `flatten` order."""
    return _map_leaves(lambda i, _: leaves[i], params, itertools.count())


def perturb(params: Params, seeds: torch.Tensor, scale, *,
            inplace: bool = False) -> Params:
    """params + scale · z(seeds), z regenerated leaf by leaf: leaf i draws
    the stream of seeds[i] (`seeds` is a direction's seed row).

    `scale` is a float or a 0-d f32 tensor (e.g. μ − η·p̂ on the device).
    `inplace=True` overwrites the leaves (the chained walk); otherwise a new
    tree is returned and `params` is untouched.
    """
    def axpy(i: int, leaf: torch.Tensor) -> torch.Tensor:
        return kops.seeded_axpy(leaf, seeds[i], _scale(scale, leaf.device),
                                out=leaf if inplace else None)
    new = _map_leaves(axpy, params, itertools.count())
    return params if inplace else new


def tag_perturbed(params: Params, seeds: torch.Tensor, scale) -> Params:
    """Tag every leaf as lazily perturbed: leaf → PerturbedParam(leaf,
    seeds[i], 0, scale), i in `flatten` order (the fused
    counterpart of `perturb`, with the same per-leaf streams). The layer
    consumers draw z inside their matmul or gather, or resolve one
    layer-sized transient; nothing is written to the leaves."""
    def tag(i: int, leaf: torch.Tensor) -> kops.PerturbedParam:
        return kops.PerturbedParam(leaf, seeds[i], 0,
                                   _scale(scale, leaf.device))
    return _map_leaves(tag, params, itertools.count())


def dual_forward(loss_fn: Callable[[Params], torch.Tensor], params: Params,
                 seeds: torch.Tensor, mu: float, mode: str = "chained"
                 ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """(loss(w+μz), loss(w−μz), params positioned for the update); z is
    drawn from the direction's seed row `seeds`.

    chained: the leaves are updated IN PLACE along the reference's exact
    axpy sequence w → w+μz → w−μz (the caller's update then walks to
    w+(μ−η·p̂)·z with a third axpy), so rounding matches `repro`'s chained
    mode step for step and the peak footprint is one θ. Returns w−μz.
    fresh: each perturbed copy is computed from w (2θ peak); returns w.
    fused: both rollouts see tagged leaves (`tag_perturbed`), eps = +μ then
    −μ, one after the other (`repro` batches the two with a vmap over eps);
    w is never written and no perturbed copy exists; returns w.
    """
    if mode == "chained":
        perturb(params, seeds, mu, inplace=True)            # w + μz
        loss_plus = loss_fn(params)
        perturb(params, seeds, -2.0 * mu, inplace=True)     # w − μz
        loss_minus = loss_fn(params)
        return loss_plus, loss_minus, params
    if mode == "fresh":
        loss_plus = loss_fn(perturb(params, seeds, mu))
        loss_minus = loss_fn(perturb(params, seeds, -mu))
        return loss_plus, loss_minus, params
    if mode == "fused":
        loss_plus = loss_fn(tag_perturbed(params, seeds, mu))
        loss_minus = loss_fn(tag_perturbed(params, seeds, -mu))
        return loss_plus, loss_minus, params
    raise ValueError(f"unknown dual mode: {mode}")


def projection(loss_plus: torch.Tensor, loss_minus: torch.Tensor, mu: float,
               clip_gamma: float) -> torch.Tensor:
    """p = (L+ − L−)/(2μ), clipped to ±γ (Assumption 3)."""
    p = (loss_plus - loss_minus) / (2.0 * mu)
    return torch.clamp(p, -clip_gamma, clip_gamma)


def apply_update(params_at: Params, seeds: torch.Tensor, p_hat: torch.Tensor,
                 lr: float, mu: float, mode: str = "chained") -> Params:
    """w ← w − η p̂ z, in place. chained: params_at = w−μz, so one axpy of
    (μ − η p̂)·z restores and updates at once; fresh and fused: params_at =
    w, axpy of (−η p̂)·z."""
    if mode == "chained":
        return perturb(params_at, seeds, mu - lr * p_hat, inplace=True)
    if mode in ("fresh", "fused"):
        return perturb(params_at, seeds, -lr * p_hat, inplace=True)
    raise ValueError(f"unknown dual mode: {mode}")
