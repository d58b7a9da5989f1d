"""Configs and the architecture registry (the dense, ssm and hybrid
families in this port)."""
from repro_torch.configs import mamba2_370m, opt_125m, recurrentgemma_2b
from repro_torch.configs.base import ModelConfig

_ARCHS = {"opt-125m": opt_125m.build, "mamba2-370m": mamba2_370m.build,
          "recurrentgemma-2b": recurrentgemma_2b.build}


def list_archs() -> list:
    return sorted(_ARCHS)


def get_arch(arch_id: str) -> ModelConfig:
    try:
        return _ARCHS[arch_id]()
    except KeyError:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported (ROADMAP A8: other families); "
            f"available: {list_archs()}") from None
