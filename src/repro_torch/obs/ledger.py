"""Trilemma ledger: one JSONL record per round, all three axes at once,
ported from `repro.obs.ledger`.

`MetricsSink` is a round hook (duck-typed against `fedsim.RoundHook`, so
this module never imports the driver) that streams one machine-readable
record per executed round:

  communication — bits this round and cumulative, from the run Transport's
    `payload_bits` with the realized survival mask (K_eff) and any defense
    payload/feedback adjustments, via the SAME `transport.uplink_bits_total`
    expression the driver uses, so the final row equals
    `RunResult.uplink_bits` exactly;
  privacy — the Eq.-16 cost charged this round, the cumulative ledger
    (bit-identical to `PrivacyAccountant.spent`: the identical float64
    left fold), and the closed-form ε it implies (`epsilon_for_budget`);
  memory — the run's `peak_bytes` watermark so far (`obs.memory`);
  plus loss, K_eff, the desync view (`k_sync`: surviving clients whose
  scalar rode the current round seed; `stale_frac`: the stale share of
  K_eff, 0.0 when desync is off), and wall-clock seconds since the sink
  started.

Line 1 is a header record carrying `schema: "trilemma_ledger/v2"` and the
run's static facts; every later line is one round. tools/check_trace.py
validates the schema and cross-checks the final row against the run
summary.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from repro_torch.core import dp
from repro_torch.core import transport as tp


class MetricsSink:
    """Round hook streaming the per-round trilemma ledger to a JSONL file.

    Implements the `RoundHook` surface (`cadence`/`on_start`/`on_round`/
    `on_boundary`/`close`) without subclassing it, so obs stays a leaf
    package. cadence 0: the sink never realigns chunk boundaries, so
    attaching it cannot change chunk shapes.
    """

    cadence = 0
    SCHEMA = "trilemma_ledger/v2"

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._exp = None
        self._t0 = 0.0
        self._payload_d = 0
        self._k_sum = 0.0
        self._bits_prev = 0
        self._spend_cum = 0.0
        self._rows = 0

    # -- RoundHook surface -------------------------------------------------
    def on_start(self, exp) -> None:
        """Open the stream and write the header record."""
        self._exp = exp
        self._t0 = time.perf_counter()
        self._payload_d = exp.model_cfg.param_count()
        self._f = open(self.path, "w")
        header = {
            "schema": self.SCHEMA,
            "arch": exp.model_cfg.name,
            "transport": exp.transport.name,
            "engine": exp.engine,
            "n_clients": exp.pz.n_clients,
            "d": self._payload_d,
            "payload_bits_per_client": exp.transport.payload_bits(
                exp.pz, self._payload_d),
            "epsilon": exp.pz.dp.epsilon,
            "delta": exp.pz.dp.delta,
        }
        self._f.write(json.dumps(header) + "\n")

    def on_round(self, t: int, metrics: Dict[str, Any]) -> None:
        """Append one trilemma record for executed round t."""
        exp = self._exp
        # round cost from the accountant's history, offset by whatever the
        # ledger held when the run started (a restored checkpoint carries
        # spent-but-unlisted budget); incremental float adds reproduce the
        # accountant's sequential cumsum fold bit for bit
        idx = exp.hist_at_start + self._rows
        hist = exp.accountant.history
        cost = float(hist[idx]) if idx < len(hist) else 0.0
        if self._rows == 0:
            self._spend_cum = exp.spent_at_start
        self._spend_cum += cost
        k_eff = float(exp.round_k_eff[t - exp.start_round])
        k_sync = float(exp.round_k_sync[t - exp.start_round])
        self._k_sum += k_eff
        self._rows += 1
        bits_cum = tp.uplink_bits_total(
            exp.transport, exp.defense, exp.pz, self._payload_d,
            self._k_sum, self._rows)
        mem = exp.telemetry.memory
        row = {
            "round": int(t),
            "loss": float(metrics["loss"]),
            "k_eff": k_eff,
            "k_sync": k_sync,
            "stale_frac": (k_eff - k_sync) / k_eff if k_eff > 0 else 0.0,
            "bits_round": bits_cum - self._bits_prev,
            "bits_cum": bits_cum,
            "dp_cost": cost,
            "dp_spent_cum": self._spend_cum,
            "eps_cum": dp.epsilon_for_budget(self._spend_cum,
                                             exp.pz.dp.delta),
            "peak_bytes": int(mem.peak_bytes) if mem is not None else 0,
            "wall_s": time.perf_counter() - self._t0,
        }
        self._bits_prev = bits_cum
        self._f.write(json.dumps(row) + "\n")

    def on_boundary(self, t_done: int, exp) -> None:
        """Flush buffered rows at every chunk boundary."""
        if self._f is not None:
            self._f.flush()

    def close(self, exp) -> None:
        """Finalize the stream: flush + fsync, then close. A run that
        completes `close` leaves a ledger whose every line parses even if
        the process is killed right after; only a kill mid-run may leave a
        torn trailing record, which readers tolerate (`read_ledger(strict=
        False)`, check_trace's truncation report). The sink then lets go
        of the run: the run holds its hooks, so a sink holding the run is
        a reference cycle that would keep the weights on the card until
        the garbage collector runs."""
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None
        self._exp = None

    # -- conveniences ------------------------------------------------------
    def rows_written(self) -> int:
        """Number of per-round records streamed so far."""
        return self._rows


def read_ledger(path: str, strict: bool = True) -> Dict[str, Any]:
    """Parse a ledger file back into {header, rows, truncated}.

    A kill mid-row leaves one torn trailing line; with ``strict=False``
    that line is dropped and reported via ``"truncated": True`` instead of
    raising. A torn line anywhere else is corruption and always raises.
    """
    raw = []
    with open(path) as f:
        for ln in f:
            if ln.strip():
                raw.append(ln)
    lines, truncated = [], False
    for i, ln in enumerate(raw):
        try:
            lines.append(json.loads(ln))
        except json.JSONDecodeError:
            if i == len(raw) - 1 and not strict:
                truncated = True
                break
            raise
    if not lines or lines[0].get("schema") != MetricsSink.SCHEMA:
        raise ValueError(f"{path}: not a {MetricsSink.SCHEMA} ledger")
    return {"header": lines[0], "rows": lines[1:], "truncated": truncated}


def final_row(path: str) -> Optional[Dict[str, Any]]:
    """Last per-round record of a ledger file (None for an empty run)."""
    rows = read_ledger(path)["rows"]
    return rows[-1] if rows else None
