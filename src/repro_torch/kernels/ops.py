"""Kernel entry points: dispatch on the tensor's device and the
implementation in use.

With no implementation named (`impl=None`, the default) a CUDA tensor
goes to the hand-written kernel (which launches or raises — there is no
fallback) and a CPU tensor to the plain PyTorch version; any other device
raises. `use_impl(impl)` names one for a block of work, with `repro`'s
names (`IMPLS`): "pallas" is the CUDA kernels, on a CPU tensor a
ValueError (there is no kernel there); "xla", "xla_chunked", "xla_full"
and "pallas_interpret" are the plain versions on either device (they play
the role of `repro`'s `ref.py` oracles and XLA fallbacks, and of its
interpreted kernel bodies); any other name raises ValueError, as in
`repro`. The entry points (`fedsim.run`, `serve_loop`) set it for a run.

`attention`, `ssd` and `linear_recurrence` are differentiable: when an
input requires grad (the first-order baseline), the card's forward is the
same hand-written kernel, run inside a `torch.autograd.Function` whose
backward recomputes the plain version from the saved inputs and returns
its vector-Jacobian product. `repro` has no backward kernel either: its FO
baseline differentiates its XLA path, the plain version. Otherwise (every
ZO path) the kernel launches as it is and nothing is saved.

`PerturbedParam` is the fused dual forward's lazy leaf w + eps·z(seed):
the consumers in `models/layers.py` fuse the perturbation into their
matmul or gather (z drawn in the kernel, never stored) or `resolve` a
layer-sized transient, so no θ-sized perturbed copy ever exists.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import perturbed_matmul as pmm
from repro_torch.kernels import rglru_scan
from repro_torch.kernels import seeded_axpy as sa
from repro_torch.kernels import ssd_scan


#: each kernel's launch counter: the module and the attribute its CUDA
#: wrapper adds one to when it launches the kernel
LAUNCH_COUNTERS = {"seeded_axpy": (sa, "launches"),
                   "seeded_gather": (sa, "gather_launches"),
                   "flash_attention": (fa, "launches"),
                   "perturbed_matmul": (pmm, "launches"),
                   "ssd_scan": (ssd_scan, "launches"),
                   "rglru_scan": (rglru_scan, "launches")}


def read_launches() -> Dict[str, int]:
    """Every kernel's launch count."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in LAUNCH_COUNTERS.items()}


#: beside each launch counter, the attributes its CUDA wrapper adds that
#: launch's f32 operations and bytes to (the module's own reckoning, as
#: chip_smoke.py's bound column makes it); read as a difference around
#: eager calls (`obs.cost.RoundCost`): a capture adds what it recorded,
#: and a replay adds nothing
WORK_COUNTERS = {"seeded_axpy": (sa, "flops", "moved_bytes"),
                 "seeded_gather": (sa, "gather_flops", "gather_moved_bytes"),
                 "flash_attention": (fa, "flops", "moved_bytes"),
                 "perturbed_matmul": (pmm, "flops", "moved_bytes"),
                 "ssd_scan": (ssd_scan, "flops", "moved_bytes"),
                 "rglru_scan": (rglru_scan, "flops", "moved_bytes")}


def read_work() -> Dict[str, Tuple[float, float]]:
    """Every kernel's (operations, bytes) over its counted launches."""
    return {name: (getattr(mod, ops), getattr(mod, moved))
            for name, (mod, ops, moved) in WORK_COUNTERS.items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add `delta` to the launch counts (a replayed CUDA graph launches the
    kernels its capture recorded without calling their wrappers)."""
    for name, n in delta.items():
        mod, attr = LAUNCH_COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


#: `repro`'s implementation names (`repro.kernels.ops`)
IMPLS = ("pallas", "pallas_interpret", "xla", "xla_chunked", "xla_full")
_impl: Optional[str] = None


def check_impl(impl: Optional[str]) -> Optional[str]:
    """`impl` if it is None or one of `IMPLS`; else ValueError."""
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl}")
    return impl


def current_impl() -> Optional[str]:
    """The implementation in use (None: by device)."""
    return _impl


@contextlib.contextmanager
def use_impl(impl: Optional[str]) -> Iterator[None]:
    """Run the block with implementation `impl` (None: by device). Not
    thread-local: the kernels run on the thread that drives the run."""
    global _impl
    check_impl(impl)
    before, _impl = _impl, impl
    try:
        yield
    finally:
        _impl = before


def _on_cuda(t: torch.Tensor) -> bool:
    """Whether `t`'s op runs the CUDA kernel (else the plain version)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device} (want cuda or cpu)")
    if _impl is None:
        return t.device.type == "cuda"
    if _impl == "pallas":
        if t.device.type != "cuda":
            raise ValueError("impl='pallas' runs the CUDA kernels; a CPU "
                             "tensor has none (impl=None or 'xla' run the "
                             "plain versions)")
        return True
    return False


def seeded_axpy(w: torch.Tensor, seed: torch.Tensor, scale: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = w + scale · z(seed); `out=w` updates in place. `seed` is the
    leaf's stream seed as one int32 element (`sa.seed_tensor`) and `scale`
    a 0-d f32 tensor, both on w's device (the plain version takes a plain
    int too)."""
    if _on_cuda(w):
        return sa.seeded_axpy_cuda(w, seed, scale,
                                   torch.empty_like(w) if out is None else out)
    res = sa.seeded_axpy_plain(w, seed, scale)
    return res if out is None else out.copy_(res)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _KernelWithPlainVjp(torch.autograd.Function):
    """forward: `kernel(*tensors, *args)`; backward: the vjp of
    `plain(*tensors, *args)`, recomputed under autograd from the saved
    inputs. Both return a tensor or a tuple of tensors (None allowed);
    `tensors` may hold None (an absent optional input). A backward run
    with `create_graph` (grad mode on inside it) recomputes the plain
    version on the saved inputs themselves and builds the vjp's graph, so
    the vjp is differentiable back to them (DLG differentiates a
    gradient); otherwise it recomputes on detached copies and builds
    none."""

    @staticmethod
    def forward(ctx, kernel, plain, n_tensors, *inputs):
        tensors, args = inputs[:n_tensors], inputs[n_tensors:]
        ctx.plain, ctx.args = plain, args
        ctx.present = [t is not None for t in tensors]
        ctx.save_for_backward(*[t for t in tensors if t is not None])
        return kernel(*tensors, *args)

    @staticmethod
    def backward(ctx, *grad_outputs):
        create = torch.is_grad_enabled()
        saved = iter(ctx.saved_tensors)

        def tracked(t):
            return t if create and t.requires_grad \
                else t.detach().requires_grad_(True)

        tensors = [tracked(next(saved)) if here else None
                   for here in ctx.present]
        with torch.enable_grad():
            out = ctx.plain(*tensors, *ctx.args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs)
                 if o is not None and g is not None]
        wrt = [t for t in tensors if t is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True, create_graph=create))
        return (None, None, None) + tuple(
            next(grads) if here else None for here in ctx.present) + (
            None,) * len(ctx.args)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Skv,D] → [B,Hq,Sq,D]."""
    if _on_cuda(q):
        if _needs_grad(q, k, v):
            return _KernelWithPlainVjp.apply(
                fa.flash_attention_cuda, fa.attention_plain, 3, q, k, v,
                causal, window, scale)
        return fa.flash_attention_cuda(q, k, v, causal, window, scale)
    return fa.attention_plain(q, k, v, causal, window, scale)


# ---------------------------------------------------------------------------
# PerturbedParam — lazy w + eps · z(seed), ported from repro.kernels.ops
# ---------------------------------------------------------------------------

class PerturbedParam:
    """A parameter leaf tagged as "perturbed by eps · z(seed) from counter
    off" (`zo.tag_perturbed` tags every leaf of the tree).

    w    — the unperturbed tensor (a whole leaf or one layer's view of it);
    seed — the leaf's stream seed (`zo.leaf_seed`): one int32 element on
           w's device holding its uint32 bits (an element of `zo.seed_row`),
           which the kernels read from device memory;
    off  — the counter of w's first element in the leaf's stream, a host
           int (0 for a whole leaf);
    eps  — the perturbation scale (±μ): a float or a 0-d f32 tensor.

    `pp[l]` slices layer l out of a scan-stacked [L, ...] leaf; its counters
    continue the whole leaf's stream (off + l·prod(rest), mod 2³²), so
    every z value equals the one `seeded_axpy` draws for the whole leaf.
    """

    def __init__(self, w: torch.Tensor, seed: torch.Tensor, off: int,
                 eps: Union[float, torch.Tensor]):
        self.w = w
        self.seed = seed
        self.off = int(off) & sa.MASK32
        self.eps = eps

    def __getitem__(self, layer: int) -> "PerturbedParam":
        if not isinstance(layer, int):
            raise TypeError("PerturbedParam slices one layer (an int index)")
        stride = math.prod(self.w.shape[1:])
        return PerturbedParam(self.w[layer], self.seed,
                              self.off + layer * stride, self.eps)

    def scale(self) -> torch.Tensor:
        """eps as a 0-d f32 tensor on w's device (the kernels read it from
        device memory)."""
        if isinstance(self.eps, torch.Tensor):
            return self.eps.to(device=self.w.device, dtype=torch.float32)
        return torch.tensor(float(self.eps), dtype=torch.float32,
                            device=self.w.device)


def perturbed_z(pp: PerturbedParam) -> torch.Tensor:
    """z of a tagged leaf (f32, w's shape): counters off + flat index."""
    return sa.draw_z(pp.w.shape, pp.seed, pp.w.device, pp.off)


def resolve(pp):
    """w + eps · z for one tagged leaf (a layer-sized transient, never a
    θ-sized one); identity on a plain tensor."""
    if not isinstance(pp, PerturbedParam):
        return pp
    if _on_cuda(pp.w):
        return sa.seeded_axpy_cuda(pp.w, pp.seed, pp.scale(),
                                   torch.empty_like(pp.w), pp.off)
    return sa.seeded_axpy_plain(pp.w, pp.seed, pp.scale(), pp.off)


def perturbed_matmul(x: torch.Tensor, pp: PerturbedParam) -> torch.Tensor:
    """x [..., K] @ (w + eps·z) for a 2-D tagged leaf w [K, N] → [..., N]
    in x's dtype; the kernel draws z inside its weight tiles."""
    w = pp.w
    if w.ndim != 2:
        raise ValueError(f"perturbed_matmul wants a 2-D leaf, got "
                         f"{tuple(w.shape)}")
    if _on_cuda(w):
        batch = x.shape[:-1]
        out = pmm.perturbed_matmul_cuda(
            x.reshape(-1, x.shape[-1]).contiguous(), w, pp.seed, pp.off,
            pp.scale())
        return out.reshape(tuple(batch) + (w.shape[1],))
    return pmm.perturbed_matmul_plain(x, w, pp.seed, pp.off, pp.scale())


def unembed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """lm head [.., D] @ w[V, D]ᵀ → f32 logits, a plain large matmul. On a
    CUDA device with bf16 operands it is one bf16 GEMM with f32 output: a
    product of two bf16 values is exact in f32 and the sums are f32, as
    `repro`'s einsum with `preferred_element_type=f32` computes it, and no
    f32 copy of [V, D] is made. Otherwise both operands are widened to f32
    (PyTorch's CPU build has no bf16 GEMM with f32 output)."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(tuple(x.shape[:-1]) + (w.shape[0],))
    return torch.matmul(x.to(torch.float32), w.to(torch.float32).t())


def perturbed_unembed(x: torch.Tensor, pp: PerturbedParam) -> torch.Tensor:
    """lm head [.., D] @ (w + eps·z)[V, D]ᵀ → f32 logits. Resolves one
    [V, D] transient in w's dtype, freed after the product (as `repro`
    does); the product itself is `unembed_matmul`."""
    return unembed_matmul(x, resolve(pp))


def perturbed_gather(pp: PerturbedParam, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """Embedding rows of (w + eps·z): z drawn only for the gathered rows
    (row v, column j draws counter off + v·D + j, its whole-table bits)."""
    if _on_cuda(pp.w):
        return sa.seeded_gather_cuda(pp.w, tokens, pp.seed, pp.scale(),
                                     pp.off)
    return sa.seeded_gather_plain(pp.w, tokens, pp.seed,
                                  pp.scale(), pp.off)


# ---------------------------------------------------------------------------
# SSD (Mamba-2)
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, state0: Optional[torch.Tensor] = None,
        chunk: int = 128, want_state: bool = True
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chunked SSD. x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N], state0
    [B,H,P,N] (zeros if None) → (y [B,S,H,P], state [B,H,P,N]), or
    (y, None) when want_state is False: the kernel then neither updates
    nor writes the final state (the plain version computes and drops it)."""
    if _on_cuda(x):
        if _needs_grad(x, dt, a, b, c, state0):
            return _KernelWithPlainVjp.apply(
                ssd_scan.ssd_scan_cuda, _ssd_plain, 6, x, dt, a, b, c,
                state0, chunk, want_state)
        return ssd_scan.ssd_scan_cuda(x, dt, a, b, c, state0, chunk,
                                      want_state)
    return _ssd_plain(x, dt, a, b, c, state0, chunk, want_state)


def _ssd_plain(x, dt, a, b, c, state0, chunk, want_state):
    y, state = ssd_scan.ssd_plain(x, dt, a, b, c, state0, chunk)
    return y, (state if want_state else None)


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, a: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update (decode), plain on every device as in `repro`
    (`repro.kernels.ops.ssd_decode_step` has no Pallas kernel). state
    [B,H,P,N] f32; x_t [B,H,P]; dt_t [B,H]; a [H]; b_t/c_t [B,N] →
    (y_t [B,H,P], state' [B,H,P,N])."""
    f32 = torch.float32
    decay = torch.exp(a[None] * dt_t)                          # [B,H]
    upd = (x_t.to(f32)[..., None] * b_t.to(f32)[:, None, None, :]
           * dt_t[..., None, None])
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_t.to(f32))
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# linear recurrence (RG-LRU)
# ---------------------------------------------------------------------------

def linear_recurrence(a: torch.Tensor, x: torch.Tensor,
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t ⊙ h_{t−1} + x_t. a, x: [B,S,D]; h0: [B,D] (zeros if
    None) → (hs [B,S,D], h_last [B,D])."""
    if _on_cuda(x):
        if _needs_grad(a, x, h0):
            return _KernelWithPlainVjp.apply(
                rglru_scan.rglru_scan_cuda,
                rglru_scan.linear_recurrence_plain, 3, a, x, h0)
        return rglru_scan.rglru_scan_cuda(a, x, h0)
    return rglru_scan.linear_recurrence_plain(a, x, h0)
