"""PyTorch/CUDA port of the pAirZero reproduction (the JAX package `repro`
stays the reference it is held against).

Subpackages mirror `repro`'s (configs, data, channel, core, models,
optim, kernels, checkpoint, runtime, launch, examples). This package imports torch and numpy only — never jax and
nothing of `repro`. Entry points (`core.fedsim.run`, `launch.train`) run on
the GPU unless the caller passes `device="cpu"`; `fedsim.run` and
`launch.serve.serve_loop` also take `repro`'s `impl=` and (the dense
family) `dtype=torch.bfloat16`.

Importing the package runs one exp on one element, on the calling thread.
torch's CPU vector math (exp, tanh, sqrt, logsumexp, ...) runs over OpenMP
threads, and the first such call of a process, when parallel, races in the
library's first-use set-up: 2–5 of 40 fresh processes got a first call that
differed from the second (ROADMAP C). After one serial call none did, for
any of these functions, so this one call guards every caller in the port.
The result bits are torch's own either way.
"""
import torch

torch.exp(torch.zeros(1))


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on.

    "cuda" (the entry points' default) raises when no GPU is present: a run
    asked for the card never quietly continues on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    return dev


#: the ROADMAP item of what `dtype=` and `impl=` do not hold yet
A12 = "ROADMAP A12: kernel implementation and dtype selection"


def resolve_dtype(dtype) -> torch.dtype:
    """The parameter dtype `dtype` names: a torch dtype, a name
    ("float32", "bfloat16"), or anything whose numpy dtype or type name is
    one (`np.float32`, `jnp.bfloat16`, matched by name so that nothing of
    jax is imported). float32 and bfloat16 run; any other dtype raises
    NotImplementedError naming A12."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        import numpy as np
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "__name__", getattr(dtype, "name", repr(dtype)))
    known = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in known:
        raise NotImplementedError(
            f"dtype={dtype!r} is not ported ({A12}): the port trains and "
            "serves in float32 and, for the dense family, bfloat16")
    return known[name]
