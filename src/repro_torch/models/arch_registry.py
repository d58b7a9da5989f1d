"""Dependency-free architecture-id registry (breaks config↔model cycles),
ported from `repro.models.arch_registry`: each config module registers its
`build` under its id when it is imported."""
from __future__ import annotations

from typing import Callable, Dict

_ARCHS: Dict[str, Callable] = {}


def register_arch(arch_id: str, builder: Callable) -> None:
    _ARCHS[arch_id] = builder


def arch_builder(arch_id: str) -> Callable:
    try:
        return _ARCHS[arch_id]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; available: "
            f"{sorted(_ARCHS)}") from None


def registered() -> list:
    return sorted(_ARCHS)
