"""Client desynchronization: stale round seeds and fractional misalignment,
ported from `repro.runtime.desync`.

Two seeded failure modes:

1. **Stale rounds.** A lagging client missed the round-t seed broadcast:
   its scalar is the projection along z_{t−d} (one shared lag d_t in
   [1, max_lag] a round, each client stale with probability `fraction`),
   so one extra fresh-mode dual forward a direction covers every stale
   client.
2. **Timing / phase misalignment.** A persistent per-client skew θ_k
   (drawn once a trace) attenuates the scalar payload by cos θ_k in
   `ota.superpose`; a conventional d-symbol analog frame accumulates it,
   the coordinate on symbol k combining with cos(kθ)
   (`conventional_frame`), the lost energy returning as interference
   (`conventional_ici`).

When a `DesyncModel` is active, `engine.build_trace` ships the rows of
`control_rows`: `dsync_seed` [R] (the lagged round seed, kept on the host
as `seed` is), `dsync_stale`, `dsync_a` and `dsync_frame` [R, K], plus
what the port's round body reads in place of the reference's in-step key
derivations: `dsync_leaf_seeds` [R, n_perturb, n_leaves] (the lagged
seed's leaf seeds, as `leaf_seeds`) and, under FO, `dsync_ici_keys`
[R, n_leaves, 2] (the interference's per-leaf threefry keys). Inactive,
the rows are absent and the round is the synchronized one, bit for bit.

Host draws use `np.random.default_rng([seed, 0xD5CA1, t])`, one generator
a round, so traces do not depend on chunking or resume.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import zo

# host rng stream tags (distinct from the noise, byzantine, sub-slot and
# channel tags)
_TRACE_TAG = 0xD5CA1
_SKEW_TAG = 0xD5CA2
#: fold_in tag of the conventional frame's interference keys
DESYNC_ICI_TAG = 0xD51C


@dataclasses.dataclass(frozen=True)
class DesyncModel:
    """Seeded per-round, per-client synchronization state.

    fraction: probability a client-round is stale (rides z_{t−d});
    max_lag: the shared lag d_t is uniform in [1, max_lag];
    phase_std: std (radians) of the persistent per-client skew θ_k;
    frame_symbols: symbols per frame of the conventional d-dimensional
        baseline (1: pAirZero's scalar payload);
    seed: host rng stream seed."""

    fraction: float = 0.0
    max_lag: int = 4
    phase_std: float = 0.0
    frame_symbols: int = 1
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"desync fraction must be in [0, 1], got "
                             f"{self.fraction}")
        if self.max_lag < 1:
            raise ValueError(f"desync max_lag must be >= 1, got "
                             f"{self.max_lag}")
        if self.phase_std < 0.0:
            raise ValueError(f"desync phase_std must be >= 0, got "
                             f"{self.phase_std}")
        if self.frame_symbols < 1:
            raise ValueError(f"desync frame_symbols must be >= 1, got "
                             f"{self.frame_symbols}")

    @classmethod
    def from_config(cls, cfg) -> "DesyncModel":
        """Build from a `configs.base.DesyncConfig`."""
        return cls(fraction=cfg.fraction, max_lag=cfg.max_lag,
                   phase_std=cfg.phase_std,
                   frame_symbols=cfg.frame_symbols, seed=cfg.seed)

    @property
    def active(self) -> bool:
        """Whether the scenario perturbs anything at all."""
        return self.fraction > 0.0 or self.phase_std > 0.0

    def sync_trace(self, t0: int, t1: int, n_clients: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
        """(stale [R,K] f32, lag [R] i64, align [R,K] f32, frame [R,K] f32)
        for rounds [t0, t1). A round t < d_t has no stale client; θ_k is
        drawn once from the round-independent skew stream; the frame row
        zeroes the stale clients (their frame carries an old round)."""
        rounds = t1 - t0
        stale = np.zeros((rounds, n_clients), dtype=np.float32)
        lag = np.zeros(rounds, dtype=np.int64)
        align = np.ones((rounds, n_clients), dtype=np.float32)
        frame = np.ones((rounds, n_clients), dtype=np.float32)
        theta = np.random.default_rng(
            [self.seed & 0xFFFFFFFF, _SKEW_TAG]).normal(
            0.0, 1.0, n_clients) * self.phase_std
        cos_theta = np.cos(theta).astype(np.float32)
        gain = frame_gain(theta, self.frame_symbols)
        for i, t in enumerate(range(t0, t1)):
            rng = np.random.default_rng(
                [self.seed & 0xFFFFFFFF, _TRACE_TAG, t])
            d = int(rng.integers(1, self.max_lag + 1))
            lag[i] = d
            s = (rng.random(n_clients) < self.fraction) & (t >= d)
            stale[i] = s.astype(np.float32)
            align[i] = cos_theta
            frame[i] = (gain * (1.0 - stale[i])).astype(np.float32)
        return stale, lag, align, frame


def frame_gain(theta: np.ndarray, n: int) -> np.ndarray:
    """Coherent gain |sin(nθ/2) / (n sin(θ/2))| of an n-symbol frame (the
    Dirichlet kernel; 1 at θ = 0)."""
    th = np.asarray(theta, dtype=np.float64)
    half = th / 2.0
    num = np.sin(n * half)
    den = n * np.sin(half)
    out = np.where(np.abs(den) < 1e-12, 1.0,
                   num / np.where(np.abs(den) < 1e-12, 1.0, den))
    return np.abs(out)


def control_rows(model: DesyncModel, base_seed: int, t0: int, t1: int,
                 n_clients: int) -> Tuple[Dict[str, np.ndarray],
                                          np.ndarray]:
    """The reference's host rows for rounds [t0, t1) and the raw stale
    matrix: `dsync_seed` is the lagged round seed round_seed(base,
    max(t − d_t, 0))."""
    stale, lag, align, frame = model.sync_trace(t0, t1, n_clients)
    ts = np.arange(t0, t1, dtype=np.int64)
    src = np.maximum(ts - lag, 0)
    seeds = np.asarray([zo.round_seed(base_seed, int(s)) for s in src],
                       dtype=np.uint32)
    rows = {
        "dsync_seed": seeds,
        "dsync_stale": stale,
        "dsync_a": align,
        "dsync_frame": frame,
    }
    return rows, stale


def ici_keys(base_seed: int, t0: int, t1: int, n_leaves: int
             ) -> np.ndarray:
    """[R, n_leaves, 2] int64: the interference keys split(fold_in(noise
    key, DESYNC_ICI_TAG), n_leaves) of rounds [t0, t1), the noise key
    being fold_in(key(base_seed ^ 0x5EED), t), as `conventional_ici`
    derives them in the reference."""
    noise = prng.fold_in(prng.key(int(base_seed) ^ 0x5EED),
                         torch.arange(t0, t1))
    return prng.split(prng.fold_in(noise, DESYNC_ICI_TAG),
                      n_leaves).numpy()


def resolve(pz) -> Optional[DesyncModel]:
    """PairZeroConfig → the active DesyncModel, or None (the synchronized
    run)."""
    cfg = getattr(pz, "desync", None)
    if cfg is None:
        return None
    model = DesyncModel.from_config(cfg)
    return model if model.active else None


def stale_payload(p_fresh: torch.Tensor, p_stale: torch.Tensor,
                  ctl: Dict) -> torch.Tensor:
    """Per client, the stale projection where ctl["dsync_stale"] is set,
    else the fresh one."""
    stale = ctl["dsync_stale"].to(p_fresh.dtype)
    return torch.where(stale > 0, p_stale, p_fresh)


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in zo.flatten(tree)]


def conventional_frame(grads, ctl: Dict, n: int):
    """Per-coordinate coherent gain of a misaligned n-symbol frame (FO),
    applied in place: coordinate c of the flattened tree (leaves in
    `zo.flatten` order, one global offset) rides symbol k = c mod n and
    combines with Σ_k' w_k' cos(k θ_k') / max(Σ mask, 1), w = mask · (1 −
    stale), θ = arccos(clip(dsync_a, −1, 1)). The gain takes n values,
    computed once and tiled over each leaf."""
    mask = ctl["mask"]
    theta = torch.arccos(torch.clamp(ctl["dsync_a"], -1.0, 1.0))   # [K]
    w = mask * (1.0 - ctl["dsync_stale"])                           # [K]
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    k = torch.arange(n, dtype=theta.dtype, device=theta.device)
    gain_n = (torch.cos(torch.outer(k, theta)) @ w) / denom        # [n]
    off = 0
    for leaf in _leaves(grads):
        size = leaf.numel()
        first = (off + torch.arange(n, device=theta.device)) % n
        gain = gain_n[first].repeat(math.ceil(size / n))[:size]
        leaf.mul_(gain.reshape(leaf.shape).to(leaf.dtype))
        off += size
    return grads


def ici_rms(ref) -> List[torch.Tensor]:
    """Per leaf of `ref`, √(mean(r²) + 1e-12): the interference's scale
    reference (the transmitted gradient, before its frame gains)."""
    return [torch.sqrt(torch.mean(torch.square(r)) + 1e-12)
            for r in _leaves(ref)]


def conventional_ici(grads, ctl: Dict, keys: torch.Tensor,
                     rms: List[torch.Tensor]):
    """Inter-symbol interference of a misaligned d-dimensional frame (FO),
    added in place: leaf i gains (scale · rms[i]) · normal(keys[i],
    leaf.shape), scale = √(Σ mask (1 − a²)) / max(Σ mask, 1) with a =
    ctl["dsync_frame"] and `rms` from `ici_rms` of the transmitted
    gradient (the reference's `ref`). `keys` is the round's [n_leaves, 2]
    row of `ici_keys`, on the device: the normals are drawn there
    (`prng.normal`), one leaf at a time."""
    mask = ctl["mask"]
    a = ctl["dsync_frame"]
    scale = (torch.sqrt(torch.sum(mask * (1.0 - a * a)))
             / torch.clamp_min(torch.sum(mask), 1.0))
    for i, (leaf, r) in enumerate(zip(_leaves(grads), rms)):
        noise = prng.normal(keys[i], leaf.shape).to(leaf.dtype)
        leaf.add_((scale * r).to(leaf.dtype) * noise)
    return grads
