"""Observability, ported from `repro.obs`: spans, watermarks, ledger,
device profile, round cost, health.

Host-side pillars, all passive (telemetry on runs bitwise the run with it
off — pinned in tests/test_torch_obs.py and on the card by chip_smoke.py):

  1. **Span timeline** (`obs.spans`) — a `Tracer` of nested wall-clock
     spans instrumented into the driver (`fedsim.Experiment`): channel
     realize, schedule solve, chunk, dispatch, metric flushes, hook
     boundaries; `ChunkPrefetcher` kick/stall and chunk prep,
     `BatchStager`, `AsyncCheckpointer` snapshot/write, the injector's
     `inject` instants and `retry` spans; exported as Chrome trace-event
     JSON (`train.py --trace-out trace.json`, loadable in Perfetto). The
     stall spans use the SAME perf_counter endpoints as the
     `prep_stall_s`/`ckpt_stall_s` scalars, so each scalar is its spans'
     sum.
  2. **Build/capture counters and memory watermark** (`obs.retrace`,
     `obs.memory`) — lru misses of the step and executor factories and
     CUDA graph captures (`RunResult.compile_stats`; a warm rerun on the
     same parameters shows zero) and device-memory samples at chunk
     boundaries (`RunResult.peak_bytes`).
  3. **Trilemma ledger** (`obs.ledger`) — a `MetricsSink` round hook
     streaming one JSONL record per round: loss, uplink bits (the driver's
     own `transport.uplink_bits_total` accounting), cumulative (ε, δ)
     spend, peak memory, wall time (`train.py --metrics-out`).

And the device-visible half:

  4. **Profiler merge** (`obs.profile`) — an opt-in `torch.profiler`
     capture (aten ops, and on the card the CUDA kernels) aligned onto the
     tracer's epoch by a `record_function` anchor and merged into the same
     Chrome trace (`train.py --profile-out`).
  5. **Round cost** (`obs.cost`) — operations, bytes and peak memory of
     one real round, counted under observing dispatch modes plus the
     hand-written kernels' own counters (`RunResult.cost_stats`, the
     Telemetry `cost` flag). The collective census of `repro.obs.hlo`
     needs the mesh engine and is not ported.
  6. **Run health** (`obs.health`) — a duck-typed `HealthMonitor` round
     hook (NaN/divergence/plateau detectors) with a warn or
     checkpoint-then-abort policy; an abort lands on `RunResult` so
     `--audit` consumes the realized (shorter) privacy spend.

`Telemetry` bundles the per-run pieces; `Telemetry.off()` (the default
everywhere) carries the shared no-op tracer and no sampler, so the
instrumented call sites cost one no-op method call when disabled.
tools/check_trace.py validates the artifact schemas.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import cost, health, ledger, memory, profile, retrace
from repro_torch.obs import spans
from repro_torch.obs.cost import CostStats
from repro_torch.obs.health import HealthAbort, HealthMonitor
from repro_torch.obs.ledger import MetricsSink, final_row, read_ledger
from repro_torch.obs.memory import MemoryWatermark
from repro_torch.obs.profile import ProfilerSession
from repro_torch.obs.spans import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Telemetry", "Tracer", "NullTracer", "NULL_TRACER", "MemoryWatermark",
    "MetricsSink", "read_ledger", "final_row",
    "HealthMonitor", "HealthAbort", "ProfilerSession", "CostStats",
    "cost", "health", "ledger", "memory", "profile", "retrace", "spans",
]


class Telemetry:
    """Per-run observability bundle: tracer + memory sampler + cost flag.

    Pass one to `fedsim.Experiment(telemetry=...)` / `fedsim.run(...)`.
    The default (`Telemetry.off()`) is inert: the shared `NULL_TRACER`, no
    memory sampling, no cost counting. `cost=True` asks the driver to count
    the run's first round (`obs.cost.RoundCost`) into
    `RunResult.cost_stats`; the counting only observes, so the run's
    numbers are unchanged.
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 memory: Optional[MemoryWatermark] = None,
                 cost: bool = False):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.memory = memory
        self.cost = bool(cost)

    @property
    def enabled(self) -> bool:
        """Whether any pillar is live (tracer, sampler, or cost stats)."""
        return self.tracer.enabled or self.memory is not None or self.cost

    @classmethod
    def on(cls, memory_sample_every: int = 32,
           cost: bool = False) -> "Telemetry":
        """Full telemetry: recording tracer + memory watermark sampler
        (+ optionally the first round's cost)."""
        return cls(tracer=Tracer(),
                   memory=MemoryWatermark(memory_sample_every), cost=cost)

    @classmethod
    def off(cls) -> "Telemetry":
        """Inert telemetry (the default): no recording, no sampling."""
        return cls()
