"""Process-wide build and capture counters, ported from `repro.obs.retrace`.

The port keeps the reference's six canonical keys, so the same
`RunResult.compile_stats` and `tools/check_trace.py --expect-chunk-traces/
--expect-step-builds` read its artifacts unchanged. There is no XLA here,
so what each key counts is the port's nearest event:

  * ``*_build`` — an lru miss of a memoized factory: `pairzero.make_zo_step`
    / `make_fo_step` (a new round body), `engine.get_loop_executor` and
    `engine.get_executor` (a new executor). A repeated config builds each
    once a process; an accidental cache-key break (an unhashable field, a
    fresh object a run) shows as a count instead of a slow run.
  * ``scan_chunk_trace`` — a CUDA graph capture of the scan engine's round
    (`engine._Graph`). The graph is kept while the leaves it updates stay
    where they are, so a chunk after the first, and a rerun on the same
    parameter tensors, capture nothing. On the CPU no graph exists and the
    count is always 0.
  * ``loop_step_trace`` — stays 0: eager rounds are never traced.

`Experiment.run` snapshots the counters around each run and reports the
delta as `RunResult.compile_stats`; a warm rerun of an identical config on
the same parameter tensors shows all zeros. A rerun on freshly allocated
parameters may capture again, depending on where the caching allocator
puts them.

Counters are process-global and monotone; consumers diff snapshots.
`suspended()` makes `bump` a no-op on the calling thread, for work that
re-enters a counted factory without being a build of the driver's.
"""
from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator

# canonical event names (the tests and check_trace key on these)
ZO_STEP_BUILD = "zo_step_build"        # make_zo_step cache miss
FO_STEP_BUILD = "fo_step_build"        # make_fo_step cache miss
LOOP_EXEC_BUILD = "loop_executor_build"  # get_loop_executor cache miss
SCAN_EXEC_BUILD = "scan_executor_build"  # get_executor cache miss
STEP_TRACE = "loop_step_trace"         # never bumped: eager rounds
CHUNK_TRACE = "scan_chunk_trace"       # CUDA graph capture of a round

CANONICAL = (ZO_STEP_BUILD, FO_STEP_BUILD, LOOP_EXEC_BUILD,
             SCAN_EXEC_BUILD, STEP_TRACE, CHUNK_TRACE)

_LOCK = threading.Lock()
_COUNTS: Counter = Counter()
_SUSPEND = threading.local()


@contextmanager
def suspended() -> Iterator[None]:
    """Make `bump()` a no-op on this thread for the duration (re-entrant:
    nesting restores the prior state)."""
    prev = getattr(_SUSPEND, "on", False)
    _SUSPEND.on = True
    try:
        yield
    finally:
        _SUSPEND.on = prev


def bump(name: str, n: int = 1) -> None:
    """Increment a counter (called from factory bodies and captures)."""
    if getattr(_SUSPEND, "on", False):
        return
    with _LOCK:
        _COUNTS[name] += n


def snapshot() -> Dict[str, int]:
    """Current value of every counter (copy)."""
    with _LOCK:
        return dict(_COUNTS)


def since(before: Dict[str, int]) -> Dict[str, int]:
    """Per-counter delta vs an earlier `snapshot()`. Every CANONICAL
    counter is always present (plus any ad-hoc names seen in either
    snapshot), so 'nothing was built' is an explicit, assertable {…: 0}
    rather than a missing key."""
    now = snapshot()
    keys = set(now) | set(before) | set(CANONICAL)
    return {k: now.get(k, 0) - before.get(k, 0) for k in sorted(keys)}
