"""First-order optimizer baselines, ported from `repro.optim.fo`: the
comparison points of the paper's Table II, FO-SGD (grads only), FO-Adam
(grads and two moments) and signSGD (Bernstein et al. 2018).

Each optimizer is a frozen dataclass (hashable, so `pairzero.make_fo_step`
memoizes on it) with `init(params)` and `update(params, grads, state) →
(params, state)`. `update` works in place on the leaves and the state, leaf
by leaf in `zo.flatten` order, so a captured CUDA graph replays it; the
temporaries are one leaf's. Adam's step count `t` is an int32 tensor on the
leaves' device and its bias corrections are computed there in f32, so
nothing in an update reads the host.

The arithmetic follows the reference's order of operations, each op
rounded to f32. XLA's CPU compiler contracts a product feeding an add or a
subtract into one fused multiply-add (`p − lr·g`, `b1·m + (1 − b1)·g`), and
XLA's f32 `pow` is its own, so the port's updates may differ from
`repro`'s by an ulp or so per op: the tests hold them to rtol 1e-6 over
three steps. signSGD's update is exact (lr·sign(g) is exact).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import zo

Params = Dict


def _leaves(tree) -> list:
    return [t for _, t in zo.flatten(tree)]


@dataclass(frozen=True)
class SGD:
    lr: float = 1e-3
    momentum: float = 0.0

    def init(self, params: Params) -> Any:
        if self.momentum == 0.0:
            return ()
        return zo.rebuild(params, [torch.zeros_like(t)
                                   for t in _leaves(params)])

    def update(self, params: Params, grads: Params, state: Any
               ) -> Tuple[Params, Any]:
        if self.momentum == 0.0:
            for p, g in zip(_leaves(params), _leaves(grads)):
                p.sub_(g.to(p.dtype) * self.lr)
            return params, ()
        for p, g, v in zip(_leaves(params), _leaves(grads), _leaves(state)):
            v.mul_(self.momentum).add_(g.to(v.dtype))
            p.sub_(v * self.lr)
        return params, state


@dataclass(frozen=True)
class Adam:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> Dict:
        leaves = _leaves(params)
        zeros = lambda: zo.rebuild(params, [  # noqa: E731
            torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in leaves])
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}

    def update(self, params: Params, grads: Params, state: Dict
               ) -> Tuple[Params, Dict]:
        t = state["t"]
        t.add_(1)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, tf)
        bc2 = 1 - torch.pow(self.b2, tf)
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"])):
            g = g.to(torch.float32)
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
            den = (v / bc2).sqrt_().add_(self.eps)
            p.sub_((m / bc1).mul_(self.lr).div_(den).to(p.dtype))
        return params, state


@dataclass(frozen=True)
class SignSGD:
    """Element-wise 1-bit compression baseline (paper ref [3]); its upload
    is d bits a round, against Sign-pAirZero's one."""
    lr: float = 1e-4

    def init(self, params: Params) -> Any:
        return ()

    def update(self, params: Params, grads: Params, state: Any
               ) -> Tuple[Params, Any]:
        for p, g in zip(_leaves(params), _leaves(grads)):
            p.sub_(torch.sign(g).to(p.dtype) * self.lr)
        return params, ()


def make(name: str, lr: float):
    return {"sgd": SGD, "adam": Adam, "signsgd": SignSGD}[name](lr=lr)
