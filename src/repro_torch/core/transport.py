"""Uplink mechanisms: the Transport protocol, ported from
`repro.core.transport` with every mechanism it registers: the OTA ones
(analog, sign, perfect), the digital baselines (digital, smart_digital)
and the first-order baseline (fo).

A Transport owns (a) the device-side `aggregate(p_k, ctl) -> p̂`, (b) the
host-side schedule solve, (c) the per-round DP cost charged to the
accountant, (d) the uplink bits per round and (e) what an eavesdropper at
the receiver sees (`observe`, `observation_spec`, `transmitted`,
`canary_payload`; `repro_torch.privacy`). Where the reference's
`aggregate` and `observe` take the round key, the port's read the draws
they need from the control block: `draws` names the per-direction rows
(`noise`, the OTA normals; `uniform`, the digital dither) that
`engine.build_trace` makes for it from that key, so `observe` reads the
very row the decode read.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Type

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import ota
from repro_torch.core.dp import round_privacy_cost

# Power-control schemes understood by the OTA transports. "perfect" doubles
# as the noise-free channel (no schedule solve, no DP spend).
OTA_SCHEMES = ("solution", "static", "reversed", "perfect")


@dataclass(frozen=True)
class Transport:
    """One uplink mechanism. Subclass + `@register(name)` to add one."""

    name = "?"
    kind = "zo"          # "fo": the first-order baseline (no scalar uplink)
    #: the per-direction rows of random draws `aggregate` reads from ctl
    draws = ("noise",)

    @classmethod
    def from_config(cls, tc, pz) -> "Transport":
        return cls()

    def aggregate(self, p: torch.Tensor, ctl: Dict) -> torch.Tensor:
        """Recover p̂ from the [K] payload vector under this round's
        control block (noise row included)."""
        raise NotImplementedError

    def make_schedule(self, trace, pz):
        """The transmit plan for the horizon; `trace` is a ChannelTrace or
        a bare [T, K] magnitude array."""
        return _trivial_schedule(trace_magnitudes(trace), scheme="perfect")

    def charges_privacy(self, schedule, pz) -> bool:
        return False

    def round_dp_costs(self, schedule, t0: int, t1: int, pz) -> np.ndarray:
        return np.zeros(t1 - t0)

    def observe(self, p: torch.Tensor, ctl: Dict) -> Dict[str, torch.Tensor]:
        """What an over-the-air listener at the receiver front-end sees when
        the [K] payloads `p` go out under this round's control block, from
        the same draw rows as the decode. Default: nothing observable."""
        return {}

    def observation_spec(self, n_clients: int) -> Dict[str, torch.Tensor]:
        """Shapes of the `observe` dict, as tensors on the meta device."""
        return {}

    def transmitted(self, p):
        """The payload actually radiated for clipped projections `p` (the
        ground truth the attacks score against): identity here."""
        return p

    def canary_payload(self, pz):
        """The worst-case payload one client contributes (the audit's
        canary); None: no DP guarantee to audit."""
        return None

    def payload_bits(self, pz, d: int) -> int:
        """Uplink bits one client sends per round (d = model dimension)."""
        raise NotImplementedError

    def bits_per_round(self, pz, d: int) -> int:
        """Total uplink bits per round: payload × clients."""
        return pz.n_clients * self.payload_bits(pz, d)


def uplink_bits_total(transport: Transport, defense, pz, d: int,
                      client_rounds: float, rounds: int) -> int:
    """Total uplink spend for `rounds` executed rounds with Σ_t K_eff(t) =
    `client_rounds` transmitting client-rounds: the payload per
    transmitting client times client-rounds, with a defense's payload
    factor and side-channel bits a round billed on top, in the reference's
    operation order."""
    bits = transport.payload_bits(pz, d) * client_rounds
    if defense is not None:
        bits = bits * defense.payload_bits_factor(pz) \
            + defense.extra_bits_per_round(pz, d) * rounds
    return int(round(bits))


def masked_ctl(ctl: Dict, mask: torch.Tensor) -> Dict:
    """The control block with its survival mask replaced: a robust
    defense decodes each sub-slot by the mechanism's own `aggregate` with
    the mask restricted to that sub-slot's clients."""
    out = dict(ctl)
    out["mask"] = mask
    return out


def _obs_spec(*shape: int) -> torch.Tensor:
    # the port's jax.ShapeDtypeStruct: a tensor with no storage
    return torch.empty(shape, dtype=torch.float32, device="meta")


def key_draws(names, keys: torch.Tensor,
              n_clients: int) -> Dict[str, torch.Tensor]:
    """The transport draw rows `names` from threefry keys [..., 2], on the
    keys' device, as the reference draws them in its step from each key:
    `noise` [..., K+1], normal(nk, (K,)) then normal(zk, ()) with nk, zk =
    split(key) (`ota.superpose`; normal(zk, ()) is element 0 of normal(zk,
    (K,))); `uniform` [..., K], uniform(key, (K,))
    (`stochastic_quantize`)."""
    out = {}
    for name in names:
        if name == "noise":
            z = prng.normal(prng.split(keys), (n_clients,))   # [..., 2, K]
            out[name] = torch.cat([z[..., 0, :], z[..., 1, :1]], dim=-1)
        elif name == "uniform":
            out[name] = prng.uniform(keys, (n_clients,))
        else:
            raise ValueError(f"unknown draw row {name!r}")
    return out


def trace_magnitudes(trace) -> np.ndarray:
    """[T, K] channel magnitudes from a ChannelTrace or a bare array."""
    return np.asarray(getattr(trace, "h", trace), dtype=np.float64)


def _trivial_schedule(h: np.ndarray, scheme: str = "perfect"):
    from repro_torch.core.power_control import PowerSchedule
    t, k = trace_magnitudes(h).shape
    return PowerSchedule(c=np.ones(t), sigma=np.zeros((t, k)),
                         scheme=scheme, n0=0.0)


def ota_dp_costs(schedule, t0: int, t1: int, gamma: float) -> np.ndarray:
    """Eq.-16 terms for rounds [t0, t1), bit-equal to the reference."""
    c = np.asarray(schedule.c[t0:t1], dtype=np.float64)
    sigma = np.asarray(schedule.sigma[t0:t1], dtype=np.float64)
    m = np.sqrt(c * c * np.sum(sigma ** 2, axis=1) + schedule.n0)
    return np.asarray([round_privacy_cost(float(c[r]), gamma, float(m[r]))
                       if c[r] != 0.0 else 0.0 for r in range(len(c))])


_REGISTRY: Dict[str, Type[Transport]] = {}


def register(name: str):
    """Class decorator adding a Transport under `name`."""
    def deco(cls: Type[Transport]) -> Type[Transport]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available() -> tuple:
    """Sorted names of every registered (ported) transport mechanism."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type[Transport]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown transport {name!r} "
                         f"(registered: {available()})") from None


def resolve(pz) -> Transport:
    """The Transport a PairZeroConfig asks for: `pz.transport` when set,
    else the legacy `variant` + `power.scheme` strings."""
    tc = pz.transport
    if tc is not None:
        return get(tc.mechanism).from_config(tc, pz)
    return from_strings(pz.variant, pz.power.scheme, pz)


def from_strings(variant: str, scheme: str, pz=None) -> Transport:
    """Legacy (variant, scheme) strings -> Transport instance."""
    if variant == "analog":
        return AnalogOTA(scheme=scheme)
    if variant == "sign":
        return SignOTA(scheme=scheme)
    if variant == "fo":
        return FirstOrder()
    if variant == "digital":
        if pz is None:
            raise ValueError("the digital transport needs run-config "
                             "context (quantizer clip range) — build it "
                             "via TransportConfig or DigitalTDMA directly")
        return DigitalTDMA(clip=float(pz.zo.clip_gamma))
    raise ValueError(f"unknown variant: {variant!r}")


@register("analog")
@dataclass(frozen=True)
class AnalogOTA(Transport):
    """Analog pAirZero: clipped projection over superposing OTA, channel
    inversion, Theorem-3 power control. Payload: one fp16 scalar per
    perturbation direction; privacy: channel noise per Lemma 1."""
    scheme: str = "solution"

    @classmethod
    def from_config(cls, tc, pz) -> "AnalogOTA":
        return cls(scheme=tc.scheme)

    def aggregate(self, p, ctl):
        if self.scheme == "perfect":
            return ota.perfect_analog(p, ctl["mask"])
        return ota.analog_ota(p, ctl["c"], ctl["sigma"], ctl["n0"],
                              ctl["noise"], ctl["mask"], ctl.get("g"),
                              ctl.get("dsync_a"))[0]

    def observe(self, p, ctl):
        """The superposed noisy scalar y of Eq. 4 from the decode's own
        noise row (the bare masked sum under "perfect")."""
        if self.scheme == "perfect":
            w = ctl["mask"].to(p.dtype)
            return {"y": torch.sum(w * p, dim=-1)}
        y, _ = ota.superpose(p, ctl["c"], ctl["sigma"], ctl["n0"],
                             ctl["noise"], ctl["mask"], ctl.get("g"),
                             ctl.get("dsync_a"))
        return {"y": y}

    def observation_spec(self, n_clients):
        return {"y": _obs_spec()}

    def canary_payload(self, pz):
        """The clip boundary γ (projections are clipped to ±γ)."""
        return None if self.scheme == "perfect" else float(pz.zo.clip_gamma)

    variant = "analog"   # the power-control family of the schedule solve

    def make_schedule(self, trace, pz):
        from repro_torch.core import power_control as pc
        return pc.make_schedule(
            self.variant, self.scheme, trace_magnitudes(trace),
            power=pz.channel.power, n0=pz.channel.n0,
            gamma=pz.zo.clip_gamma, n_clients=pz.n_clients, e0=pz.power.e0,
            contraction_a=pz.power.contraction_a,
            contraction_a_tilde=pz.power.contraction_a_tilde,
            epsilon=pz.dp.epsilon, delta=pz.dp.delta)

    def charges_privacy(self, schedule, pz) -> bool:
        return bool(pz.dp.enabled and schedule.scheme != "perfect")

    def round_dp_costs(self, schedule, t0, t1, pz):
        return ota_dp_costs(schedule, t0, t1, pz.zo.clip_gamma)

    def payload_bits(self, pz, d):
        return 16 * pz.zo.n_perturb


@register("sign")
@dataclass(frozen=True)
class SignOTA(AnalogOTA):
    """Sign-pAirZero: 1-bit majority consensus via superposition (Eq. 11),
    Theorem-4 power control. The DP sensitivity is 1 (signs), not γ."""
    scheme: str = "solution"
    variant = "sign"

    def aggregate(self, p, ctl):
        if self.scheme == "perfect":
            return ota.perfect_sign(p, ctl["mask"])
        return ota.sign_ota(p, ctl["c"], ctl["sigma"], ctl["n0"],
                            ctl["noise"], ctl["mask"], ctl.get("g"),
                            ctl.get("dsync_a"))[0]

    def observe(self, p, ctl):
        """The superposed noisy vote count of the ±1 ballots."""
        return super().observe(torch.sign(p), ctl)

    def transmitted(self, p):
        """The on-air payload: the sign of the clipped projection."""
        return np.sign(p) if isinstance(p, np.ndarray) else torch.sign(p)

    def canary_payload(self, pz):
        """A ±1 ballot."""
        return None if self.scheme == "perfect" else 1.0

    def round_dp_costs(self, schedule, t0, t1, pz):
        return ota_dp_costs(schedule, t0, t1, 1.0)

    def payload_bits(self, pz, d):
        return 1 * pz.zo.n_perturb


@register("perfect")
@dataclass(frozen=True)
class PerfectUplink(AnalogOTA):
    """Noise-free superposition upper bound (Eq. 38) as a mechanism of its
    own (legacy spelling: variant="analog", scheme="perfect")."""
    scheme: str = "perfect"

    @classmethod
    def from_config(cls, tc, pz) -> "PerfectUplink":
        return cls()


# ---------------------------------------------------------------------------
# Digital baseline (conventional orthogonal transmission)
# ---------------------------------------------------------------------------

def deprecated_strings(variant: str, scheme: str, where: str) -> None:
    """The reference's one-release DeprecationWarning for string dispatch."""
    warnings.warn(
        f"{where}: string-dispatched variant={variant!r}/scheme={scheme!r} "
        "is deprecated; pass a TransportConfig (configs.base) or a Transport "
        "from repro_torch.core.transport instead. The shim routes through "
        "the transport registry and will be removed next release.",
        DeprecationWarning, stacklevel=3)


def stochastic_quantize(p: torch.Tensor, u: torch.Tensor, *, bits: int,
                        clip: float) -> torch.Tensor:
    """Unbiased b-bit stochastic quantizer on [-clip, +clip]: the range in
    2^b − 1 cells, a value rounded up to its cell's upper edge with
    probability its fractional position, so E[Q(p)] = clamp(p). `u` holds
    the uniforms the reference draws with `jax.random.uniform(key,
    p.shape)`."""
    levels = np.float32(2 ** bits - 1)
    half = np.float32(clip)
    v = (torch.clamp(p, -float(half), float(half)) + float(half)) \
        * float(levels / (np.float32(2.0) * half))
    lo = torch.floor(v)
    up = (u < (v - lo)).to(p.dtype)
    return (lo + up) * float(np.float32(2.0) * half / levels) - float(half)


@register("digital")
@dataclass(frozen=True)
class DigitalTDMA(Transport):
    """Conventional digital uplink: b-bit stochastic quantization, one
    orthogonal TDMA slot per client, no superposition, no DP mechanism.
    Without the shared-seed trick a client uploads its whole d-dimensional
    update at `quant_bits` per coordinate; the trajectory applies the
    statistically equivalent scalar form (each client's clipped projection
    quantized, every scheduled slot decoded error-free and averaged).
    Privacy: none, so the accountant is never charged."""
    quant_bits: int = 8
    clip: float = 1.0
    draws = ("uniform",)

    @classmethod
    def from_config(cls, tc, pz) -> "DigitalTDMA":
        return cls(quant_bits=tc.quant_bits, clip=float(pz.zo.clip_gamma))

    def aggregate(self, p, ctl):
        """The mean of the scheduled slots' quantized payloads (clients
        masked out yield their slots); per-slot decode is coherent, so the
        CSI factor g does not enter."""
        mask = ctl["mask"].to(p.dtype)
        q = stochastic_quantize(p, ctl["uniform"], bits=self.quant_bits,
                                clip=self.clip)
        return torch.sum(mask * q) / torch.clamp_min(torch.sum(mask), 1.0)

    def observe(self, p, ctl):
        """Every scheduled slot's quantized payload, decoded individually
        from the decode's own dither row (unscheduled slots: 0)."""
        mask = ctl["mask"].to(p.dtype)
        q = stochastic_quantize(p, ctl["uniform"], bits=self.quant_bits,
                                clip=self.clip)
        return {"q": mask * q}

    def observation_spec(self, n_clients):
        return {"q": _obs_spec(n_clients)}

    def make_schedule(self, trace, pz):
        """No power control to solve: TDMA slots run at scheduled SNR."""
        return _trivial_schedule(trace_magnitudes(trace), scheme="digital")

    def payload_bits(self, pz, d):
        return self.quant_bits * d


@register("smart_digital")
@dataclass(frozen=True)
class SmartDigital(DigitalTDMA):
    """FedZO-style seed-and-scalar digital uplink: z regenerated from the
    broadcast seed, so a client sends one b-bit scalar per perturbation
    direction over its TDMA slot. Decode and schedule as `DigitalTDMA`;
    orthogonal decoding still exposes every client's scalar."""

    def payload_bits(self, pz, d):
        return self.quant_bits * pz.zo.n_perturb


# ---------------------------------------------------------------------------
# First-order baseline
# ---------------------------------------------------------------------------

@register("fo")
@dataclass(frozen=True)
class FirstOrder(Transport):
    """FO FedSGD/Adam baseline: full backprop and a d-dimensional fp16
    gradient upload, the cost pAirZero eliminates. The gradients average
    inside the step (`pairzero.make_fo_step`)."""
    kind = "fo"
    draws = ()

    def aggregate(self, p, ctl):
        raise NotImplementedError("the FO baseline averages gradients in the "
                                  "step itself; it has no scalar uplink")

    def payload_bits(self, pz, d):
        return 16 * d
