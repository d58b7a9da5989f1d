"""PyTorch/CUDA port of the pAirZero reproduction (the JAX package `repro`
stays the reference it is held against).

Subpackages mirror `repro`'s (configs, data, channel, core, models,
optim, kernels, checkpoint, runtime, launch, examples). This package imports torch and numpy only — never jax and
nothing of `repro`. Entry points (`core.fedsim.run`, `launch.train`) run on
the GPU unless the caller passes `device="cpu"`.

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
