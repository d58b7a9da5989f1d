"""Round execution for the loop engine, ported from `repro.core.engine`.

A pAirZero trajectory is a pure function of (params, seeds, schedule): the
per-round control — c(t), σ(t), the broadcast seed, the survival mask, the
CSI factors and the OTA noise — is known once the base station has solved
the power schedule. `build_trace` stacks it for a span of rounds and ships
it to the device in one transfer; `LoopExecutor` walks it one round at a
time. The host keeps the DP accounting: the run's Transport prices each
round and the hard privacy stop truncates a span at the first round that
would overspend. The scan executor is not ported yet.

The OTA noise is data here: `noise_rows` draws each round's
[n_perturb, K+1] standard normals from a torch.Generator seeded by
(seed ^ 0x5EED, t), so a trace does not depend on how rounds are chunked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import transport as tp
from repro_torch.core import zo
from repro_torch.core.dp import PrivacyAccountant

Params = Dict


@dataclass
class ControlTrace:
    """Stacked per-round control for rounds [t0, t0+R).

    `ctl` holds seed [R] (host uint32 — the kernels take seeds as launch
    arguments) and device tensors c [R], sigma [R,K], n0 [R], mask [R,K],
    g [R,K] and noise [R, n_perturb, K+1]. `host_masks` is the host view of
    the mask for the uplink-bit accounting."""
    t0: int
    ctl: Dict
    acct_cost: np.ndarray     # [R] per-round DP cost
    charged: bool             # whether these rounds cost privacy at all
    host_masks: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(len(self.ctl["seed"]))

    def rows(self, n: int) -> Dict:
        """First n rounds of the stacked control block."""
        if n == len(self):
            return self.ctl
        return {k: v[:n] for k, v in self.ctl.items()}


def noise_rows(seed: int, t0: int, t1: int, n_perturb: int,
               n_clients: int) -> np.ndarray:
    """[R, n_perturb, K+1] f32 standard normals for rounds [t0, t1): per
    direction j, K artificial-noise draws then the receiver-noise draw.
    Round t's rows come from its own generator, seeded by (seed ^ 0x5EED, t)."""
    out = np.empty((t1 - t0, n_perturb, n_clients + 1), dtype=np.float32)
    key = ((int(seed) ^ 0x5EED) & 0xFFFFFFFF) << 32
    for r, t in enumerate(range(t0, t1)):
        gen = torch.Generator().manual_seed(key | (t & 0xFFFFFFFF))
        out[r] = torch.randn((n_perturb, n_clients + 1), generator=gen,
                             dtype=torch.float32).numpy()
    return out


def build_trace(schedule, pz, t0: int, t1: int, *, device,
                transport: Optional[tp.Transport] = None) -> ControlTrace:
    """Precompute the control trace for rounds [t0, t1).

    The ported channel (Rayleigh, perfect CSI, no outage) and the absence of
    fault models make every mask and CSI factor 1, as the reference's trace
    is for that configuration."""
    if transport is None:
        transport = tp.resolve(pz)
    k = pz.n_clients
    rounds = int(t1 - t0)
    masks = np.ones((rounds, k), dtype=np.float32)
    host_ctl = {
        "c": np.asarray(schedule.c[t0:t1], dtype=np.float32),
        "sigma": np.asarray(schedule.sigma[t0:t1], dtype=np.float32),
        "n0": np.full((rounds,), schedule.n0, dtype=np.float32),
        "mask": masks,
        "g": np.ones((rounds, k), dtype=np.float32),
        "noise": noise_rows(pz.seed, t0, t1, pz.zo.n_perturb, k),
    }
    ctl = {key: torch.from_numpy(v).to(device) for key, v in host_ctl.items()}
    ctl["seed"] = np.asarray([zo.round_seed(pz.seed, t)
                              for t in range(t0, t1)], dtype=np.uint32)
    charged = bool(transport.charges_privacy(schedule, pz))
    acct_cost = transport.round_dp_costs(schedule, t0, t1, pz) \
        if charged else np.zeros(rounds)
    return ControlTrace(t0=t0, ctl=ctl, acct_cost=acct_cost, charged=charged,
                        host_masks=masks)


def affordable_rounds(accountant: PrivacyAccountant, trace: ControlTrace,
                      slack: float = 1e-6) -> int:
    """How many leading rounds of `trace` the DP budget affords (pure
    lookahead, the same float64 left fold as the reference)."""
    if not trace.charged:
        return len(trace)
    costs = np.asarray(trace.acct_cost, dtype=np.float64)
    cum = np.cumsum(np.concatenate(([accountant.spent], costs)))
    over = np.flatnonzero(cum[1:] > accountant.budget * (1.0 + slack))
    return int(over[0]) if over.size else len(trace)


def charge_rounds(accountant: PrivacyAccountant, trace: ControlTrace,
                  n: int) -> None:
    """Charge the accountant for the first n rounds of the trace."""
    if not trace.charged or n <= 0:
        return
    accountant.spend_batch(np.asarray(trace.acct_cost[:n], dtype=np.float64))


def stack_batches(pipeline, t0: int, t1: int, device) -> Dict[str,
                                                               torch.Tensor]:
    """Round batches [R, K, b, S] for rounds [t0, t1) on `device` (labels
    dropped, token ids as int64 for indexing)."""
    per_round = [pipeline.batch(t) for t in range(t0, t1)]
    out = {}
    for key in per_round[0]:
        if key == "labels":
            continue
        arr = np.stack([b[key] for b in per_round])
        if arr.dtype == np.int32:
            arr = arr.astype(np.int64)
        out[key] = torch.from_numpy(arr).to(device)
    return out


class LoopExecutor:
    """Per-round dispatch of the round body over a stacked trace."""

    def __init__(self, step: Callable):
        self._step = step

    def run(self, params: Params, ctl_stack: Dict,
            batch_stack: Dict[str, torch.Tensor]
            ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        rounds = len(ctl_stack["seed"])
        collected: Dict[str, list] = {}
        for r in range(rounds):
            ctl = {k: v[r] for k, v in ctl_stack.items()}
            batch = {k: v[r] for k, v in batch_stack.items()}
            params, metrics = self._step(params, batch, ctl)
            for k, v in metrics.items():
                collected.setdefault(k, []).append(v)   # no per-round sync
        return params, {k: torch.stack(v) for k, v in collected.items()}


def chunk_boundaries(start: int, stop: int, chunk_rounds: int,
                     align: Tuple[int, ...] = ()) -> list:
    """Split [start, stop) into chunks of ≤ chunk_rounds, also cutting at
    every multiple of each period in `align` (hook cadences)."""
    periods = [p for p in align if p and p > 0]
    bounds = []
    t = start
    while t < stop:
        nxt = min(t + max(1, chunk_rounds), stop)
        for p in periods:
            m = ((t // p) + 1) * p
            if t < m < nxt:
                nxt = m
        bounds.append((t, nxt))
        t = nxt
    return bounds
