"""The cost of one round: operations, bytes and peak memory, counted as it
runs. The port's counterpart of `repro.obs.hlo`'s FLOP/byte part
(`CostStats`, `describe`).

The reference reads XLA's analyses of the compiled program and runs
nothing. PyTorch compiles no program, so the port observes a real round
instead: `RoundCost` wraps the first eager round of a run's first chunk
(the loop engine's first round, the scan engine's round before its
capture) in two dispatch modes that only observe:

  * `torch.utils.flop_counter.FlopCounterMode` — the operations of every
    aten op it has a formula for (matmuls count 2·M·N·K);
  * a byte counter — the operand and result bytes of every other aten op
    that moves data (views and bare allocations move none).

The hand-written kernels are reached through ctypes, so neither mode sees
them: each wrapper adds its launch's operations and bytes to a counter
beside its launch counter (`kernels.ops.read_work`), and the round's delta
is added here. On the CPU the wrappers run the plain versions, which the
modes see instead. `peak_bytes` is the card's allocator high-water mark
(`max_memory_allocated`) at the end of the counted round, the run's peak so
far (0 on the CPU). Nothing is counted inside a CUDA graph capture. A
process's first dispatch mode imports `torch._dynamo`, so its first
counted round also pays that import (PERF.md §5).
`collectives` stays empty: the collective census needs the mesh engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops as kops
from repro_torch.obs import memory

_aten = torch.ops.aten
# ops that allocate or relabel storage without reading or writing it
_NO_TRAFFIC = frozenset((_aten.empty.memory_format, _aten.empty_like.default,
                         _aten.empty_strided.default))


@dataclass
class CostStats:
    """One round's account of its work (the reference's per-program
    numbers, counted on a real round here)."""

    flops: float = 0.0              # aten ops' and kernels' operations
    bytes_accessed: float = 0.0     # aten ops' and kernels' bytes
    kernel_flops: float = 0.0       # of which the hand-written kernels'
    kernel_bytes: float = 0.0
    peak_bytes: int = 0             # allocator high-water mark (card)
    collectives: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        """Total operand bytes over every collective occurrence."""
        return float(sum(e["bytes"] for e in self.collectives.values()))

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready view (what RunResult and the trace record)."""
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "peak_bytes": self.peak_bytes,
                "collective_bytes": self.collective_bytes,
                "collectives": self.collectives}


def describe(stats, indent: str = "  ") -> str:
    """Human-readable block for a CostStats (or its dict)."""
    if hasattr(stats, "to_dict"):
        stats = stats.to_dict()
    lines = [
        f"{indent}flops            {stats['flops']:.3e}"
        f"  (kernels {stats['kernel_flops']:.3e})",
        f"{indent}bytes accessed   {stats['bytes_accessed']:.3e}"
        f"  (kernels {stats['kernel_bytes']:.3e})",
        f"{indent}peak bytes       {stats['peak_bytes']:,}",
    ]
    colls = stats.get("collectives") or {}
    if not colls:
        lines.append(f"{indent}collectives      none")
    for op, ent in sorted(colls.items()):
        lines.append(f"{indent}{op:<16} x{ent['count']}  "
                     f"{ent['bytes']:.3e} B")
    return "\n".join(lines)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor operands and results of each aten op
    that moves data; runs every op as it is."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(_nbytes(x) for x in leaves)
        return out


class RoundCost:
    """Context manager counting one round's cost (`stats()` after exit).

    Observation only: the modes run every op as it is, so the round's
    numbers are bitwise those of an uncounted round. Counts the calling
    thread (and the autograd engine's threads it hands a backward to)."""

    def __init__(self, device=None):
        # imported here: `torch.utils.flop_counter` imports triton where it
        # is installed, which no run without cost counting should pay
        from torch.utils.flop_counter import FlopCounterMode
        self.device = device
        self._stats: Optional[CostStats] = None
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter()
        self._work0 = None

    def __enter__(self) -> "RoundCost":
        self._work0 = kops.read_work()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        work = kops.read_work()
        k_flops = sum(work[k][0] - self._work0[k][0] for k in work)
        k_bytes = sum(work[k][1] - self._work0[k][1] for k in work)
        peak = memory.device_peak_bytes(self.device) \
            if self.device is not None else None
        self._stats = CostStats(
            flops=float(self._flops.get_total_flops()) + k_flops,
            bytes_accessed=float(self._bytes.bytes) + k_bytes,
            kernel_flops=k_flops, kernel_bytes=k_bytes,
            peak_bytes=int(peak or 0))
        return False

    def stats(self) -> Optional[CostStats]:
        """The counted round's CostStats (None before the round ran)."""
        return self._stats
