"""Eavesdropper observation model, ported from `repro.privacy.adversary`:
what an over-the-air listener at the receiver front-end records.

Analog and sign OTA: one superposed noisy scalar a round (Eq. 4, what
Lemma 1 privatizes); digital and smart_digital: every scheduled client's
quantized payload; fo: the victim's raw gradient (`obs_grad0`,
`pairzero.make_fo_step`). `Adversary.observe` delegates to the round's
Transport (`Transport.observe`), which reads the same draw rows as the
decode, so the capture is bitwise the signal the server inverted; the
prefixed observations ride the round's metrics, which both engines stack
alike, and capture never moves the trajectory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.core.pairzero import OBS_PREFIX

__all__ = ["OBS_PREFIX", "Adversary"]


@dataclass(frozen=True)
class Adversary:
    """The worst-case listener: as capable as the base station itself
    (same front-end, same channel knowledge). Frozen and hashable: part of
    the memoized step's key."""

    def observe(self, transport, p: torch.Tensor,
                ctl: Dict) -> Dict[str, torch.Tensor]:
        """The prefixed observation dict of one round's [K] payloads."""
        obs = transport.observe(p, ctl)
        return {OBS_PREFIX + k: v for k, v in obs.items()}

    def observation_spec(self, transport,
                         n_clients: int) -> Dict[str, torch.Tensor]:
        """Shapes of `observe()` (tensors on the meta device)."""
        return {OBS_PREFIX + k: v
                for k, v in transport.observation_spec(n_clients).items()}
