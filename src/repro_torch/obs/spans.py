"""Host-side span timeline: nested wall-clock spans + instant events,
ported from `repro.obs.spans` (pure Python there and here).

The tracer is the single clock for every host-side latency the driver
cares about — chunk prep, prefetch stalls, checkpoint snapshots, schedule
solves, metric flushes — recorded as (name, start, end, args) spans on a
shared `time.perf_counter` epoch. It is deliberately boring: pure Python,
thread-safe via one lock, no torch imports, so instrumented code paths stay
structurally identical whether telemetry is on (a `Tracer`) or off (the
shared `NULL_TRACER`, whose every method is a no-op).

Export is Chrome trace-event JSON (`export_chrome`), loadable directly in
Perfetto / chrome://tracing: spans become "X" complete events, instants
"i" events, counters "C" events, with one lane per host thread (the
driver, the chunk-prefetch worker, checkpoint writers).

Exactness contract: callers that already measure a latency (e.g.
`ChunkPrefetcher.stall_s`) record the span with `add_span` using the SAME
perf_counter endpoints they accumulate, so the sum of span durations
equals the legacy scalar exactly — the scalars are kept as derived sums,
never as a second clock.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Tracer:
    """Thread-safe collector of wall-clock spans on one perf_counter epoch.

    Spans nest naturally through the `span(...)` context manager; code
    that measures its own interval reports it verbatim via `add_span`.
    `events()` returns host-side dicts (seconds, float) for tests and
    derived sums; `export_chrome` writes the Perfetto-loadable JSON.
    """

    def __init__(self):
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._threads: Dict[int, str] = {}

    # -- recording --------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        if ident not in self._threads:
            self._threads[ident] = threading.current_thread().name
        return ident

    def add_span(self, name: str, start: float, end: float, **args) -> None:
        """Record a completed span from raw perf_counter endpoints (the
        exactness path: the caller's own measurement IS the span)."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "X", "tid": self._tid(),
                "ts": start - self._epoch, "dur": end - start, "args": args})

    @contextmanager
    def span(self, name: str, **args):
        """Context manager recording the enclosed wall-clock interval."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, t0, time.perf_counter(), **args)

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (e.g. a prefetch kick)."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "tid": self._tid(),
                "ts": time.perf_counter() - self._epoch, "args": args})

    def counter(self, name: str, value: float, **args) -> None:
        """Record a sampled counter value (e.g. live device bytes)."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "C", "tid": self._tid(),
                "ts": time.perf_counter() - self._epoch,
                "args": {"value": float(value), **args}})

    # -- reading ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """Whether this tracer records anything (False on NULL_TRACER)."""
        return True

    @property
    def epoch(self) -> float:
        """The perf_counter instant that is t=0 for every span. External
        clocks (e.g. torch.profiler in `obs.profile`) align their
        events onto the timeline by shifting relative to this epoch."""
        return self._epoch

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of every recorded event (ts/dur in seconds)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Completed spans, optionally filtered by name, in record order."""
        return [e for e in self.events()
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def total_s(self, name: str) -> float:
        """Sum of durations of every span called `name` (seconds). With
        `add_span` callers reporting their own endpoints, this equals the
        legacy scalar accumulator to float addition order."""
        return sum(e["dur"] for e in self.spans(name))

    # -- export -----------------------------------------------------------
    def export_chrome(self, path: str,
                      metadata: Optional[Dict[str, Any]] = None,
                      extra_events: Optional[List[Dict[str, Any]]] = None,
                      ) -> None:
        """Write Chrome trace-event JSON (Perfetto / chrome://tracing).

        `metadata` lands under `otherData` — the validation harness
        (tools/check_trace.py) cross-checks span-derived sums against the
        run's legacy counters recorded there.

        `extra_events` are pre-formed Chrome events appended verbatim —
        the profiler-merge path (`obs.profile`) hands over device-op
        events already shifted onto this tracer's epoch, on their own pid
        so they render as a separate Perfetto process lane next to the
        host spans (which always live on pid 0).
        """
        with self._lock:
            events = [dict(e) for e in self._events]
            threads = dict(self._threads)
        out = []
        for ident, tname in sorted(threads.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": ident, "args": {"name": tname}})
        for e in events:
            rec = {"name": e["name"], "ph": e["ph"], "pid": 0,
                   "tid": e["tid"], "ts": e["ts"] * 1e6,
                   "cat": "obs", "args": e["args"]}
            if e["ph"] == "X":
                rec["dur"] = e["dur"] * 1e6
            if e["ph"] == "i":
                rec["s"] = "t"
            out.append(rec)
        if extra_events:
            out.extend(extra_events)
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": metadata or {}}
        with open(path, "w") as f:
            json.dump(doc, f)


class _NullContext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class NullTracer(Tracer):
    """No-op tracer: every instrumented call site stays a plain method
    call whether telemetry is on or off, so the telemetry-off program is
    structurally identical to the historical one (neutrality pin)."""

    def __init__(self):  # no lock, no buffers
        pass

    @property
    def enabled(self) -> bool:
        """Always False: nothing is ever recorded."""
        return False

    def add_span(self, name, start, end, **args):
        """No-op."""

    def span(self, name, **args):
        """Shared no-op context manager (no allocation per call)."""
        return _NULL_CTX

    def instant(self, name, **args):
        """No-op."""

    def counter(self, name, value, **args):
        """No-op."""

    def events(self):
        """Always empty."""
        return []

    @property
    def epoch(self) -> float:
        """Epoch of the null timeline (0.0; nothing aligns to it)."""
        return 0.0

    def export_chrome(self, path, metadata=None, extra_events=None):
        """Refuse silently: there is nothing to export."""


NULL_TRACER = NullTracer()
