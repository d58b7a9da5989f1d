"""Run-health monitoring: catch a diverging ZO run before it burns budget
(ported from `repro.obs.health`, pure Python there and here).

Long-horizon ZO fine-tuning fails quietly: a bad lr or a poisoned round
sends the loss to NaN or 10x its best, and the driver keeps charging the
DP accountant for rounds that can never help. `HealthMonitor` watches the
same per-round metrics stream the trilemma ledger reads and applies three
detectors:

  * **nonfinite** — loss is NaN/Inf this round;
  * **divergence** — loss exceeds `divergence_factor` x the running best;
  * **plateau**    — no improvement over the best for `plateau_rounds`
    consecutive rounds (off by default).

Policy `"warn"` records rising-edge events and lets the run proceed;
`"abort"` raises `HealthAbort` from `on_round`, which the driver catches
at chunk granularity — executed rounds stay equal to charged rounds, so
`RunResult.privacy_spent` is the *realized* (shorter) spend and
`train.py --audit` audits exactly what was bought (the abort itself is
recorded on `RunResult` and `train.py` exits with status 3).

Like `MetricsSink`, this is a duck-typed RoundHook — cadence 0 (it can
never realign chunk boundaries), no fedsim import, purely host-side reads
of already-materialized metrics. Off (no hook attached) the driver runs
the bit-exact historical program; on, it is numerically passive — both
pinned in tests on loop and scan.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

POLICIES = ("warn", "abort")


class HealthAbort(RuntimeError):
    """Raised by HealthMonitor(policy="abort") on the first detection.

    Carries the round and reason; `Experiment.run` converts it into
    `RunResult.health_abort_round` / `health_abort_reason` after a
    best-effort checkpoint of the last completed boundary.
    """

    def __init__(self, round_: int, reason: str):
        super().__init__(f"health abort at round {round_}: {reason}")
        self.round = int(round_)
        self.reason = reason


class HealthMonitor:
    """NaN/divergence/plateau watcher over the per-round metrics stream.

    `events` collects rising-edge detections as
    ``{"round", "kind", "loss"}`` dicts (a kind re-fires only after it
    recovers, so an 8000-round plateau is one event, not 8000). With
    ``policy="abort"`` the first detection raises `HealthAbort` instead.
    """

    cadence = 0          # never realigns chunk boundaries

    def __init__(self, policy: str = "warn", *,
                 divergence_factor: float = 10.0,
                 plateau_rounds: int = 0,
                 plateau_tol: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown health policy: {policy!r} (want {POLICIES})")
        self.policy = policy
        self.divergence_factor = float(divergence_factor)
        self.plateau_rounds = int(plateau_rounds)
        self.plateau_tol = float(plateau_tol)
        self.events: List[Dict[str, Any]] = []
        self._best = math.inf
        self._since_best = 0
        self._firing: set = set()

    # -- RoundHook surface (duck-typed; cadence-0 contract) ---------------
    def on_start(self, exp) -> None:
        """Reset detector state for a fresh run."""
        self._best = math.inf
        self._since_best = 0
        self._firing.clear()

    def _fire(self, t: int, kind: str, loss: float) -> None:
        if kind not in self._firing:
            self._firing.add(kind)
            self.events.append(
                {"round": int(t), "kind": kind, "loss": float(loss)})
        if self.policy == "abort":
            raise HealthAbort(t, kind)

    def on_round(self, t: int, metrics: Dict[str, Any]) -> None:
        """Check this round's loss against the three detectors."""
        if "loss" not in metrics:
            return
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            self._fire(t, "nonfinite", loss)
            return
        if loss < self._best - self.plateau_tol:
            self._best = min(self._best, loss)
            self._since_best = 0
            self._firing.clear()      # recovered: kinds may re-fire later
        else:
            self._best = min(self._best, loss)
            self._since_best += 1
        if (self.divergence_factor > 0 and math.isfinite(self._best)
                and loss > self.divergence_factor * max(self._best, 1e-12)):
            self._fire(t, "divergence", loss)
            return
        if self.plateau_rounds > 0 and self._since_best >= self.plateau_rounds:
            self._fire(t, "plateau", loss)

    def on_boundary(self, t_done: int, exp) -> None:
        """No boundary-side effects (detectors are per-round)."""

    def close(self, exp) -> None:
        """Nothing to flush — events live on the monitor object."""
