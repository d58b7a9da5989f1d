"""Byzantine client behaviors: what an active adversarial client radiates,
ported from `repro.byzantine.behaviors`.

A `ClientBehavior` rewrites the [K] payload vector before the Transport's
aggregate, so a malicious payload superposes through the real decode.
Which clients misbehave is a seeded host-side cohort (`client_mask`),
shipped as the control trace's ctl["byz"] row. How they misbehave runs in
the round body; where the reference draws from a per-round attack key,
fold_in(round key, BYZ_KEY_TAG), the port's behaviors name the rows they
read (`draws`) and `draw_rows` makes them on the host from those very
keys (`repro_torch.prng`), as `engine.build_trace` does for the OTA noise.

Built-ins: sign_flip (transmit −p_k, the paper's Fig. 4 adversary),
scaled_poison (−λ·p_k), gaussian_noise (p_k + N(0, std²)) and
colluding_cohort (every colluder sends the clip boundary with a shared
random sign). `resolve(pz)` is None without a ByzantineConfig, for
behavior "none" or fraction 0: the round is then the honest one, bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Type

import numpy as np
import torch

from repro_torch import prng

#: fold_in tag of the per-round attack key (from the direction's round key)
BYZ_KEY_TAG = 0xB52
#: host rng tag of the cohort draw
_COHORT_TAG = 0xB52C0


@dataclass(frozen=True)
class ClientBehavior:
    """One active-adversary payload rewrite. Subclass + `@register(name)`.

    `fraction` of the K clients run it (cohort size round(f·K), drawn once
    a run from `seed`). Frozen and hashable: part of the memoized step's
    key."""

    name = "?"
    #: the per-direction rows `apply` reads from the control block
    draws = ()
    fraction: float = 0.25
    seed: int = 0

    @classmethod
    def from_config(cls, bz, pz) -> "ClientBehavior":
        return cls(fraction=float(bz.fraction), seed=int(bz.seed))

    def client_mask(self, n_clients: int) -> np.ndarray:
        """[K] f32 indicator of the malicious cohort (1 = attacker): the
        first round(f·K) of a seeded numpy permutation."""
        m = min(max(int(round(self.fraction * n_clients)), 0), n_clients)
        mask = np.zeros((n_clients,), dtype=np.float32)
        if m:
            rng = np.random.default_rng(
                (int(self.seed) & 0xFFFFFFFF) ^ _COHORT_TAG)
            mask[rng.permutation(n_clients)[:m]] = 1.0
        return mask

    def draw_rows(self, keys: torch.Tensor,
                  n_clients: int) -> Dict[str, np.ndarray]:
        """The rows of `draws` from the attack keys [..., 2]
        (fold_in(round key, BYZ_KEY_TAG) of each round and direction)."""
        return {}

    def apply(self, p: torch.Tensor, byz: torch.Tensor,
              ctl: Dict) -> torch.Tensor:
        """Rewrite the payload `p` where the cohort indicator `byz` is 1;
        honest entries pass through bitwise unchanged."""
        raise NotImplementedError


def attack_keys(round_keys: torch.Tensor) -> torch.Tensor:
    """fold_in(round key, BYZ_KEY_TAG) for round keys [..., 2]."""
    return prng.fold_in(round_keys, BYZ_KEY_TAG)


def apply_behavior(behavior: ClientBehavior, p: torch.Tensor,
                   ctl: Dict) -> torch.Tensor:
    """`behavior` on the payload vector in the round body, gated by the
    cohort row ctl["byz"]."""
    return behavior.apply(p, ctl["byz"].to(p.dtype), ctl)


_REGISTRY: Dict[str, Type[ClientBehavior]] = {}


def register(name: str):
    """Class decorator adding a ClientBehavior under `name`."""
    def deco(cls: Type[ClientBehavior]) -> Type[ClientBehavior]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available() -> tuple:
    """Sorted names of every registered client behavior."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type[ClientBehavior]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown behavior {name!r} "
                         f"(registered: {available()})") from None


def resolve(pz) -> Optional[ClientBehavior]:
    """The behavior a PairZeroConfig asks for, or None (no
    ByzantineConfig, behavior "none" or fraction 0: the honest run)."""
    bz = getattr(pz, "byzantine", None)
    if bz is None or bz.behavior == "none" or bz.fraction <= 0.0:
        return None
    return get(bz.behavior).from_config(bz, pz)


@register("sign_flip")
@dataclass(frozen=True)
class SignFlip(ClientBehavior):
    """The paper's Fig. 4 adversary: transmit −p_k (inside the honest clip
    range)."""

    def apply(self, p, byz, ctl):
        return torch.where(byz > 0, -p, p)


@register("scaled_poison")
@dataclass(frozen=True)
class ScaledPoison(ClientBehavior):
    """Amplified flip: transmit −λ·p_k (past the honest ±γ range for
    λ > 1, what the transmit clip saturates)."""
    scale: float = 3.0

    @classmethod
    def from_config(cls, bz, pz) -> "ScaledPoison":
        return cls(fraction=float(bz.fraction), seed=int(bz.seed),
                   scale=float(bz.scale))

    def apply(self, p, byz, ctl):
        return torch.where(byz > 0, -float(np.float32(self.scale)) * p, p)


@register("gaussian_noise")
@dataclass(frozen=True)
class GaussianNoise(ClientBehavior):
    """Jamming: the cohort adds N(0, std²) to its payload. The normals are
    the reference's normal(fold_in(attack key, 1), (K,)), the row
    `byz_noise` [K]."""
    std: float = 3.0
    draws = ("byz_noise",)

    @classmethod
    def from_config(cls, bz, pz) -> "GaussianNoise":
        return cls(fraction=float(bz.fraction), seed=int(bz.seed),
                   std=float(bz.scale))

    def draw_rows(self, keys, n_clients):
        return {"byz_noise": prng.normal(prng.fold_in(keys, 1),
                                         (n_clients,)).numpy()}

    def apply(self, p, byz, ctl):
        noise = float(np.float32(self.std)) * ctl["byz_noise"].to(p.dtype)
        return p + byz * noise


@register("colluding_cohort")
@dataclass(frozen=True)
class ColludingCohort(ClientBehavior):
    """Coordinated attack: every colluder transmits the same clip-boundary
    payload with a shared random sign a round, the reference's
    bernoulli(fold_in(attack key, 2)) (row `byz_flip`, 1.0 = flip)."""
    payload: float = 5.0
    draws = ("byz_flip",)

    @classmethod
    def from_config(cls, bz, pz) -> "ColludingCohort":
        return cls(fraction=float(bz.fraction), seed=int(bz.seed),
                   payload=float(pz.zo.clip_gamma))

    def draw_rows(self, keys, n_clients):
        flip = prng.bernoulli(prng.fold_in(keys, 2))
        return {"byz_flip": flip.to(torch.float32).numpy()}

    def apply(self, p, byz, ctl):
        s = torch.where(ctl["byz_flip"] > 0, -1.0, 1.0).to(p.dtype)
        return torch.where(byz > 0, s * float(np.float32(self.payload)), p)
