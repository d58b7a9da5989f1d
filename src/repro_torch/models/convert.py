"""Carry `repro`'s params across: a nested dict of numpy arrays (the JAX
params after `np.asarray` on each leaf) becomes the port's nested dict of
tensors on `device`. Both packages keep the same keys, lists and
scan-stacked layout, so after conversion they compute the same function."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cpu") -> Dict:
    if isinstance(tree, dict):
        return {k: params_from_numpy(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device).contiguous()
