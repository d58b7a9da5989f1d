"""Device-memory watermark sampling (the trilemma's memory axis, per run),
ported from `repro.obs.memory`.

Periodic samples of device bytes at chunk boundaries, folded into a
`peak_bytes` watermark surfaced on `RunResult` and in every trilemma-ledger
row. Two sources, best first:

  * `torch.cuda.max_memory_allocated(device)` — the caching allocator's
    high-water mark on the run's card (the reference's
    `peak_bytes_in_use`); None on the CPU;
  * the bytes of the live tensors' storages (`live_buffer_bytes`, a walk of
    the garbage collector's tracked objects, each storage counted once) —
    an instantaneous view, so the boundary cadence is what makes it a
    watermark.

Sampling is host-side and read-only: it never touches the round's tensors
(telemetry-off and telemetry-on runs are bitwise the same).
"""
from __future__ import annotations

import gc
from typing import Iterable, List, Optional, Tuple

import torch

from repro_torch.obs import spans


def live_buffer_bytes(tensors: Optional[Iterable] = None,
                      device=None) -> int:
    """Bytes of the storages behind live tensors (on `device`'s type when
    given), each storage counted once: views of one storage (a slice, a
    reshape, `x[None]`) share it and add nothing. `tensors` defaults to
    every tensor the garbage collector tracks; tests pass an explicit list.
    """
    want = None if device is None else torch.device(device).type
    if tensors is None:
        # type(), not isinstance: a lazy module attribute's __class__ may
        # warn when read
        tensors = (o for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor))
    seen = set()
    total = 0
    for t in tensors:
        try:
            if want is not None and t.device.type != want:
                continue
            storage = t.untyped_storage()
            ptr = storage.data_ptr()
            key = (str(t.device), ptr)
            if ptr == 0 or key in seen:
                continue
            seen.add(key)
            total += int(storage.nbytes())
        except Exception:  # noqa: BLE001 - meta, sparse or freed tensors
            continue
    return total


def device_peak_bytes(device=None) -> Optional[int]:
    """The allocator's high-water mark on `device` (default: the current
    CUDA device, when there is one), or None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


class MemoryWatermark:
    """Periodic device-memory sampler with a running peak.

    `sample_every` is a round period gating `due(t)`; the driver samples
    at chunk boundaries that cross it (cadence 0: sampling never realigns
    chunk boundaries, so it can never change chunk shapes).
    """

    def __init__(self, sample_every: int = 32):
        self.sample_every = max(1, int(sample_every))
        self.peak_bytes = 0
        self.samples: List[Tuple[int, int]] = []   # (round, bytes)
        self._last_t: Optional[int] = None

    def due(self, t: int) -> bool:
        """Whether round t crosses the sampling period since last sample."""
        return self._last_t is None or t - self._last_t >= self.sample_every

    def sample(self, t: int, tracer: spans.Tracer = spans.NULL_TRACER,
               device=None) -> int:
        """Take one sample at round t on `device`; returns the bytes
        observed and advances the `peak_bytes` watermark (also emitted as a
        `device_bytes` counter event for the timeline view)."""
        peak = device_peak_bytes(device)
        b = peak if peak is not None else live_buffer_bytes(device=device)
        self.peak_bytes = max(self.peak_bytes, b)
        self.samples.append((int(t), int(b)))
        self._last_t = int(t)
        tracer.counter("device_bytes", b, round=int(t))
        return b
