"""Device-op capture merged onto the host span timeline (one Perfetto view),
ported from `repro.obs.profile`.

`torch.profiler` records what actually ran — the aten ops on the host, and
on the card the CUDA runtime calls and every kernel (CUPTI) — on its own
clock and in its own Chrome trace. The span tracer (`obs.spans`) records
host-side truth (chunk_prep / dispatch / prep_stall) on a `perf_counter`
epoch. This module joins the two:

  1. `ProfilerSession.start()` starts a `torch.profiler.profile` (CPU
     activity, plus CUDA when a card is present) and immediately marks an
     **anchor** with `torch.profiler.record_function(ANCHOR)` at a recorded
     `perf_counter` instant. The anchor shows up verbatim as an event in
     the profiler's trace, giving an exact shift between the profiler clock
     and the tracer epoch.
  2. `device_events(epoch)` loads the Chrome trace the profiler exported,
     shifts every timestamp by the anchor offset onto the tracer epoch, and
     rebadges pid 0 — where Kineto puts GPU 0's kernels — so the device
     lanes render as their own Perfetto process next to the host spans
     (which always live on pid 0).
  3. `Tracer.export_chrome(..., extra_events=...)` appends them: host spans
     and kernels on ONE timeline (`train.py --profile-out`).

Opt-in and strictly additive: the profiler observes, it never reschedules,
and a broken capture degrades to an empty event list with the error in the
meta dict (which `tools/check_trace.py --require-device-lane` rejects).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

# rebadged pid of the profiler's pid-0 lanes (GPU 0's kernels)
DEVICE_PID = 1_000_000


class ProfilerSession:
    """One opt-in `torch.profiler` capture, alignable to a Tracer epoch.

    Lifecycle: `start()` before the run, `stop()` after, then
    `device_events(tracer.epoch)` for the merged-timeline events. Every
    failure (profiler unavailable, nothing exported) degrades to an empty
    event list with the error recorded in the meta dict: a broken profiler
    must never fail the run it was watching.
    """

    ANCHOR = "obs_profile_anchor"

    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir or tempfile.mkdtemp(prefix="obs_profile_")
        self.path = os.path.join(self.logdir, "torch_trace.json")
        self._prof = None
        self._anchor_host: Optional[float] = None
        self._start_host: Optional[float] = None
        self._error: Optional[str] = None

    def start(self) -> None:
        """Begin capture and stamp the clock anchor."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        try:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._start_host = time.perf_counter()
            self._anchor_host = time.perf_counter()
            with record_function(self.ANCHOR):
                pass
        except Exception as exc:  # noqa: BLE001 - profiler unavailable
            self._prof = None
            self._error = f"{type(exc).__name__}: {exc}"

    def stop(self) -> None:
        """End capture and export the profiler's Chrome trace to `path`."""
        if self._prof is None:
            return
        try:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(self.path)
        except Exception as exc:  # noqa: BLE001 - record, don't raise
            self._error = f"{type(exc).__name__}: {exc}"
        self._prof = None

    def device_events(self, epoch: float
                      ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
        """Profiler events shifted onto a tracer epoch (µs Chrome events).

        Returns ``(events, meta)``: events ready for
        `Tracer.export_chrome(extra_events=...)`; meta records the event
        count, the count of CUDA kernel events (`kernels`), whether the
        exact anchor was found (vs the first-event fallback), the applied
        offset, and any capture error.
        """
        meta: Dict[str, Any] = {"events": 0, "kernels": 0, "anchor": False,
                                "offset_us": 0.0}
        if self._error:
            meta["error"] = self._error
        if self._start_host is None or not os.path.exists(self.path):
            return [], meta
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except Exception as exc:  # noqa: BLE001 - a torn export
            meta["error"] = f"{type(exc).__name__}: {exc}"
            return [], meta
        raw = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        kept: List[Dict[str, Any]] = []
        anchor_ts: Optional[float] = None
        min_ts: Optional[float] = None
        for e in raw:
            ph = e.get("ph")
            if ph == "M":
                if "pid" in e and "name" in e:
                    kept.append(dict(e))
                continue
            if ph not in ("X", "i", "C"):
                continue             # flow arrows and the like
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or "pid" not in e \
                    or "tid" not in e:
                continue
            e = dict(e)
            if ph == "X" and not isinstance(e.get("dur"), (int, float)):
                e["dur"] = 0.0
            kept.append(e)
            min_ts = ts if min_ts is None else min(min_ts, ts)
            if e.get("name") == self.ANCHOR and anchor_ts is None:
                anchor_ts = ts
        if anchor_ts is not None:
            offset = (self._anchor_host - epoch) * 1e6 - anchor_ts
            meta["anchor"] = True
        elif min_ts is not None:
            offset = (self._start_host - epoch) * 1e6 - min_ts
        else:
            offset = 0.0
        meta["offset_us"] = offset
        for e in kept:
            if e.get("pid") == 0:
                e["pid"] = DEVICE_PID
            if isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] + offset
        meta["events"] = sum(1 for e in kept if e.get("ph") != "M")
        meta["kernels"] = sum(1 for e in kept if e.get("cat") == "kernel")
        meta["source"] = self.path
        return kept, meta
