"""AttackHook, ported from `repro.privacy.hooks`: collect the adversary's
observations from a live run through the round-hook protocol
(`core.fedsim.RoundHook`), with the attack's ground truth beside them (the
clients' true payloads `p_clients` and the surviving count `k_eff`)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.fedsim import RoundHook
from repro_torch.privacy.adversary import OBS_PREFIX


class AttackHook(RoundHook):
    """Per-round observation capture for post-hoc attacks and audits.

    `max_rounds` caps how many rounds are kept on the host (the FO
    uplink's obs_grad0 is a whole [d] gradient a round); None keeps
    every round."""

    def __init__(self, prefix: str = OBS_PREFIX,
                 max_rounds: Optional[int] = None):
        self.prefix = prefix
        self.max_rounds = max_rounds
        self.rounds: List[int] = []
        self._obs: Dict[str, List[np.ndarray]] = {}
        self._payloads: List[np.ndarray] = []
        self._k_eff: List[float] = []

    def on_round(self, t: int, metrics: Dict[str, np.ndarray]) -> None:
        if self.max_rounds is not None and len(self.rounds) >= \
                self.max_rounds:
            return
        got = {k: v for k, v in metrics.items() if k.startswith(self.prefix)}
        if not got:
            return
        self.rounds.append(t)
        for k, v in got.items():
            self._obs.setdefault(k, []).append(np.asarray(v))
        if "p_clients" in metrics:
            self._payloads.append(np.asarray(metrics["p_clients"]))
        if "k_eff" in metrics:
            self._k_eff.append(float(metrics["k_eff"]))

    def observations(self) -> Dict[str, np.ndarray]:
        """Stacked [T, ...] observation streams, keyed as captured."""
        return {k: np.stack(v) for k, v in self._obs.items()}

    def payloads(self) -> Optional[np.ndarray]:
        """[T, K] true per-client projections (the attacks' ground
        truth)."""
        return np.stack(self._payloads) if self._payloads else None

    def k_eff(self) -> Optional[np.ndarray]:
        """[T] surviving-client counts the decode inverted by."""
        return np.asarray(self._k_eff) if self._k_eff else None
