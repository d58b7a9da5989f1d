"""Deterministic fault injection and bounded retry for the host pipeline,
ported from `repro.runtime.inject`.

A `FaultInjector` arms named *sites*, the places the training loop touches
the outside world, with seeded, replayable faults:

=================  ====================================================
site               where it fires
=================  ====================================================
``chunk_prep``     entry of ChunkPrefetcher's prepare (worker thread or
                   inline), before the control trace is built
``dispatch``       entry of an executor's chunk dispatch
``ckpt_snapshot``  entry of AsyncCheckpointer.save's snapshot
``ckpt_write``     entry of the checkpoint writer, per attempt
=================  ====================================================

Modes form a small registry: ``exception`` raises `InjectedFault`,
``delay`` sleeps then proceeds, ``torn_write`` asks the site to truncate
the file it just wrote (only ``ckpt_write`` honours it: the bitrot that
`checkpoint.latest_valid` must skip on resume).

Faults fire at site entry, before any stateful host RNG (FaultModel) or
device buffer is touched, so a retry replays the site from a clean slate.
Whether an invocation fires is a pure function of (injector seed, site,
invocation index): an exact ``@i,j,...`` selector, or a Bernoulli draw from
`np.random.default_rng([seed, crc32(site), n])`, the reference's draw, so
the same specs fire at the same invocations in both packages.

Telemetry (`obs.spans`): every fired fault drops an ``inject`` instant on
the injector's tracer, and every re-attempt of `with_retries` runs inside a
``retry`` span; the recoveries are also counted (`retries`, `fired`).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.spans import NULL_TRACER

SITES = ("chunk_prep", "dispatch", "ckpt_snapshot", "ckpt_write")

_MODES: Dict[str, "FaultMode"] = {}


def register_mode(name: str):
    """Class decorator: register a fault mode under `name`."""
    def deco(cls):
        _MODES[name] = cls()
        cls.name = name
        return cls
    return deco


def available_modes() -> Tuple[str, ...]:
    """Registered fault-mode names."""
    return tuple(sorted(_MODES))


class InjectedFault(RuntimeError):
    """Raised by the ``exception`` mode at an armed site."""


class FaultMode:
    """A way for an armed site to misbehave; see the registry above."""

    name = "?"

    def trigger(self, site: str, invocation: int,
                fault: "SiteFault") -> Optional[str]:
        """Fire at `site`: raise, sleep, or return a marker string."""
        raise NotImplementedError


@register_mode("exception")
class ExceptionMode(FaultMode):
    """Raise `InjectedFault`: the site's caller must recover."""

    def trigger(self, site, invocation, fault):
        raise InjectedFault(
            f"injected fault at site {site!r} (invocation {invocation})")


@register_mode("delay")
class DelayMode(FaultMode):
    """Sleep `delay_s`, then let the site proceed (a straggling host op)."""

    def trigger(self, site, invocation, fault):
        time.sleep(fault.delay_s)
        return "delay"


@register_mode("torn_write")
class TornWriteMode(FaultMode):
    """Ask the site to truncate its output file after writing it."""

    def trigger(self, site, invocation, fault):
        return "torn_write"


@dataclasses.dataclass(frozen=True)
class SiteFault:
    """One armed site: its mode and when it fires. `at` (exact invocation
    indices) wins over `p` (a per-invocation Bernoulli draw); `delay_s`
    matters only to the ``delay`` mode."""

    mode: str
    p: float = 1.0
    at: Tuple[int, ...] = ()
    delay_s: float = 0.02

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r} "
                             f"(available: {available_modes()})")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], "
                             f"got {self.p}")


class FaultInjector:
    """Seeded registry of armed sites; host-side only, replayable.

    `fire(site)` advances the site's invocation counter and, when the
    (seed, site, invocation) draw says so, triggers the armed mode. It
    returns the mode's marker (``"torn_write"``, ``"delay"``) or None when
    nothing fired; the ``exception`` mode raises instead."""

    def __init__(self, faults: Mapping[str, SiteFault], seed: int = 0,
                 tracer=NULL_TRACER):
        for site in faults:
            if site not in SITES:
                raise ValueError(f"unknown injection site {site!r} "
                                 f"(available: {SITES})")
        self.faults = dict(faults)
        self.seed = int(seed)
        self.tracer = tracer
        self.counts: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    @classmethod
    def from_specs(cls, specs: Sequence[str], seed: int = 0,
                   tracer=NULL_TRACER) -> "FaultInjector":
        """Build from CLI specs ``site:mode[:selector]``: the selector is a
        probability (``0.25``) or exact invocation indices (``@2`` /
        ``@2,5``); omitted means every invocation."""
        faults: Dict[str, SiteFault] = {}
        for spec in specs:
            parts = spec.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"bad --inject spec {spec!r} "
                                 "(want site:mode[:selector])")
            site, mode = parts[0], parts[1]
            p, at = 1.0, ()
            if len(parts) == 3:
                sel = parts[2]
                if sel.startswith("@"):
                    at = tuple(int(x) for x in sel[1:].split(","))
                else:
                    p = float(sel)
            faults[site] = SiteFault(mode=mode, p=p, at=at)
        return cls(faults, seed=seed, tracer=tracer)

    def armed(self, site: str) -> bool:
        """Whether `site` has a fault armed."""
        return site in self.faults

    def fire(self, site: str) -> Optional[str]:
        """Advance `site`'s counter; trigger the armed mode if due."""
        n = self.counts.get(site, 0)
        self.counts[site] = n + 1
        fault = self.faults.get(site)
        if fault is None:
            return None
        if fault.at:
            hit = n in fault.at
        else:
            rng = np.random.default_rng(
                [self.seed & 0xFFFFFFFF, zlib.crc32(site.encode()), n])
            hit = bool(rng.random() < fault.p)
        if not hit:
            return None
        self.fired[site] = self.fired.get(site, 0) + 1
        self.tracer.instant("inject", site=site, mode=fault.mode,
                            invocation=n)
        return _MODES[fault.mode].trigger(site, n, fault)


def with_retries(fn: Callable, *, site: str, attempts: int = 3,
                 injector: Optional[FaultInjector] = None,
                 tracer=NULL_TRACER, backoff_s: float = 0.01,
                 retries: Optional[Dict[str, int]] = None):
    """Call `fn` with bounded retry and exponential backoff.

    The injector (when given) fires at each attempt's entry, before `fn`
    runs, so retried work replays from a clean slate. Each re-attempt runs
    in a ``retry`` span (site, attempt, the exception class that forced it)
    and is counted into `retries[site]`; the last exception propagates once
    `attempts` are spent. `attempts=1` is a plain call (the sites where a
    failure mid-flight cannot be replayed)."""
    try:
        if injector is not None:
            injector.fire(site)
        return fn()
    except Exception as exc:  # noqa: BLE001 - bounded retry seam
        last = exc
    for attempt in range(1, attempts):
        if retries is not None:
            retries[site] = retries.get(site, 0) + 1
        with tracer.span("retry", site=site, attempt=attempt,
                         error=type(last).__name__):
            time.sleep(backoff_s * (2 ** (attempt - 1)))
            try:
                if injector is not None:
                    injector.fire(site)
                return fn()
            except Exception as exc:  # noqa: BLE001 - bounded retry seam
                last = exc
    raise last
