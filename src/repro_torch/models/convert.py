"""Carry `repro`'s params across: a nested dict of numpy arrays (the JAX
params after `np.asarray` on each leaf) becomes the port's nested dict of
tensors on `device`. Both packages keep the same keys, lists and
scan-stacked layout, so after conversion they compute the same function.

A bf16 leaf arrives as a numpy array of `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses. It is matched by its dtype's name (nothing of
`ml_dtypes` is imported: the card's machine has none), viewed as uint16,
and its bits reinterpreted as torch.bfloat16: the same values, bitwise."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def leaf_from_numpy(a, device="cpu") -> torch.Tensor:
    """One leaf: a numpy array (or anything `np.asarray` takes) as a
    contiguous tensor on `device`, bf16 included."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device).contiguous()
    return torch.from_numpy(a).to(device).contiguous()


def params_from_numpy(tree: Any, device="cpu") -> Dict:
    if isinstance(tree, dict):
        return {k: params_from_numpy(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    return leaf_from_numpy(tree, device)
