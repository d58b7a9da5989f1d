"""OTA-compatible Byzantine defenses, ported from `repro.byzantine.defenses`.

The superposition hands the server one noisy scalar a resource block, so
a defense is a countermeasure the air interface permits:

  clip          — every payload saturated at ±γ_d = clip_factor·γ, the
                  tightened bound folded into the Theorem-3/4 solve
                  (`power_control.defended_config`);
  robust_decode — clients permuted into `groups` orthogonal sub-slots each
                  round, each decoded by the mechanism's own `aggregate`,
                  the masked median of the estimates taken;
  reweight      — the same sub-slot decodes, those whose residual from the
                  median exceeds `thresh`·MAD dropped, the rest averaged.

Where the reference draws in its step (the group permutation from
fold_in(round key, 0xD3F0), each sub-slot's own channel use from
`ota.subslot_keys`), the port's defenses name rows (`draws(transport)`)
that `draw_rows` makes on the host from those keys: `group_of` [K] (each
client's sub-slot) and, for each row the transport reads, `subslot_<row>`
[groups, ...] (the OTA normals, or the digital dither, of each sub-slot).

Privacy and communication are priced through the run's Transport:
`make_schedule`, `charges_privacy`, `round_dp_costs`, `audited_pz`,
`payload_bits_factor`, `extra_bits_per_round`, `resource_blocks`.
`resolve(pz)` is None for no defense: the round calls the transport's
aggregate, bit for bit the undefended run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Type

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import ota
from repro_torch.core import power_control as pc
from repro_torch.core import transport as tp

#: fold_in tag of the per-round sub-slot assignment draw
_GROUP_TAG = 0xD3F0


@dataclass(frozen=True)
class Defense:
    """One server/PHY-side countermeasure. Subclass + `@register(name)`.
    The base class is the identity defense: every hook delegates to the
    Transport."""

    name = "?"

    @classmethod
    def from_config(cls, bz, pz) -> "Defense":
        return cls()

    # -- round body --------------------------------------------------------
    def transmit(self, p: torch.Tensor, ctl: Dict) -> torch.Tensor:
        """The client-side PHY constraint on every payload. Identity."""
        return p

    def aggregate(self, transport: tp.Transport, p: torch.Tensor,
                  ctl: Dict) -> torch.Tensor:
        """The server's decode: the mechanism's own."""
        return transport.aggregate(p, ctl)

    def draws(self, transport: tp.Transport) -> tuple:
        """The per-direction rows `aggregate` reads beyond the
        transport's own."""
        return ()

    def draw_rows(self, transport: tp.Transport, keys: torch.Tensor,
                  n_clients: int) -> Dict[str, np.ndarray]:
        """The rows of `draws` from the round keys [..., 2] of each round
        and direction."""
        return {}

    # -- host side (schedule + DP accounting) ------------------------------
    def make_schedule(self, transport: tp.Transport, trace, pz):
        return transport.make_schedule(trace, pz)

    def charges_privacy(self, transport: tp.Transport, schedule,
                        pz) -> bool:
        return transport.charges_privacy(schedule, pz)

    def round_dp_costs(self, transport: tp.Transport, schedule, t0: int,
                       t1: int, pz):
        return transport.round_dp_costs(schedule, t0, t1, pz)

    def audited_pz(self, pz):
        """The config the DP audit runs against. Unchanged."""
        return pz

    # -- communication accounting -----------------------------------------
    def payload_bits_factor(self, pz) -> float:
        return 1.0

    def extra_bits_per_round(self, pz, d: int) -> int:
        return 0

    def resource_blocks(self) -> int:
        """Orthogonal resource blocks a round (1; group decodes: groups)."""
        return 1


_REGISTRY: Dict[str, Type[Defense]] = {}


def register(name: str):
    """Class decorator adding a Defense under `name`."""
    def deco(cls: Type[Defense]) -> Type[Defense]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available() -> tuple:
    """Sorted names of every registered defense."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type[Defense]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown defense {name!r} "
                         f"(registered: {available()})") from None


def resolve(pz) -> Optional[Defense]:
    """The defense a PairZeroConfig asks for, or None ("none" or no
    ByzantineConfig)."""
    bz = getattr(pz, "byzantine", None)
    if bz is None or bz.defense == "none":
        return None
    return get(bz.defense).from_config(bz, pz)


@register("clip")
@dataclass(frozen=True)
class TransmitClip(Defense):
    """Every payload saturated at ±γ_d, and the schedule, the DP costs and
    the audit's canary solved with the tightened sensitivity."""
    clip: float = 1.0

    @classmethod
    def from_config(cls, bz, pz) -> "TransmitClip":
        return cls(clip=float(bz.clip_factor) * float(pz.zo.clip_gamma))

    def transmit(self, p, ctl):
        half = float(np.float32(self.clip))
        return torch.clamp(p, -half, half)

    def make_schedule(self, transport, trace, pz):
        return transport.make_schedule(trace,
                                       pc.defended_config(pz, self.clip))

    def charges_privacy(self, transport, schedule, pz):
        return transport.charges_privacy(schedule,
                                         pc.defended_config(pz, self.clip))

    def round_dp_costs(self, transport, schedule, t0, t1, pz):
        return transport.round_dp_costs(schedule, t0, t1,
                                        pc.defended_config(pz, self.clip))

    def audited_pz(self, pz):
        return pc.defended_config(pz, self.clip)


def _group_assignment(keys: torch.Tensor, k_total: int,
                      groups: int) -> torch.Tensor:
    """[..., K] int64 sub-slot of each client for round keys [..., 2]: the
    reference's zeros.at[permutation(fold_in(key, 0xD3F0), K)].set(arange(K)
    % groups)."""
    perm = prng.permutation(prng.fold_in(keys, _GROUP_TAG), k_total)
    slots = (torch.arange(k_total) % groups).expand(perm.shape)
    return torch.zeros(perm.shape, dtype=torch.int64).scatter(-1, perm,
                                                              slots)


def _group_estimates(transport: tp.Transport, p: torch.Tensor, ctl: Dict,
                     groups: int):
    """([groups] estimates, [groups] validity): sub-slot g decoded by the
    mechanism's own aggregate with the mask restricted to its clients and
    its own draw rows; valid when a surviving client landed in it."""
    ests, valid = [], []
    for g in range(groups):
        gmask = ctl["mask"] * (ctl["group_of"] == g).to(ctl["mask"].dtype)
        sub = tp.masked_ctl(ctl, gmask)
        for name in transport.draws:
            sub[name] = ctl["subslot_" + name][g]
        ests.append(transport.aggregate(p, sub))
        valid.append(torch.sum(gmask) > 0)
    return torch.stack(ests), torch.stack(valid)


def _masked_median(values: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """The median over the valid entries (sort with +inf in the invalid
    places; the two middle entries read by a gather, no host read)."""
    srt = torch.sort(torch.where(valid, values, torch.inf))[0]
    n = torch.clamp_min(torch.sum(valid.to(torch.int32)), 1)
    mid = torch.stack([torch.div(n - 1, 2, rounding_mode="floor"),
                       torch.div(n, 2, rounding_mode="floor")]).to(
        torch.int64)
    pair = torch.gather(srt, 0, mid)
    return 0.5 * (pair[0] + pair[1])


@dataclass(frozen=True)
class _GroupDecode(Defense):
    groups: int = 4

    @classmethod
    def from_config(cls, bz, pz):
        return cls(groups=int(bz.groups))

    def draws(self, transport):
        return ("group_of",) + tuple("subslot_" + name
                                     for name in transport.draws)

    def draw_rows(self, transport, keys, n_clients):
        rows = {"group_of": _group_assignment(
            keys, n_clients, self.groups).to(torch.float32).numpy()}
        sub = tp.key_draws(transport.draws,
                           ota.subslot_keys(keys, self.groups), n_clients)
        rows.update({"subslot_" + name: v.numpy() for name, v in
                     sub.items()})
        return rows

    def resource_blocks(self):
        """One orthogonal block per sub-slot."""
        return self.groups


@register("robust_decode")
@dataclass(frozen=True)
class RobustDecode(_GroupDecode):
    """The masked median of `groups` sub-slot decodes (median of means;
    breakdown point ⌊(m − 1)/2⌋ corrupted sub-slots)."""

    def aggregate(self, transport, p, ctl):
        est, valid = _group_estimates(transport, p, ctl, self.groups)
        return _masked_median(est, valid)


@register("reweight")
@dataclass(frozen=True)
class ResidualReweight(_GroupDecode):
    """Sub-slot decodes with a residual above `thresh`·MAD from their
    median dropped, the rest averaged; the accept/reject bitmap costs
    `groups` downlink bits a round."""
    thresh: float = 3.0

    def aggregate(self, transport, p, ctl):
        est, valid = _group_estimates(transport, p, ctl, self.groups)
        center = _masked_median(est, valid)
        resid = torch.abs(est - center)
        mad = _masked_median(resid, valid)
        keep = valid & (resid <= float(np.float32(self.thresh)) * mad
                        + float(np.float32(1e-12)))
        w = keep.to(est.dtype)
        nk = torch.sum(w)
        return torch.where(nk > 0,
                           torch.sum(w * est) / torch.clamp_min(nk, 1.0),
                           center)

    def extra_bits_per_round(self, pz, d):
        return self.groups
