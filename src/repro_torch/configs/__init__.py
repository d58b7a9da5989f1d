"""Configs and the architecture registry (the dense, moe, ssm and hybrid
families in this port)."""
from repro_torch.configs import (deepseek_coder_33b, deepseek_v2_236b,
                                 granite_34b, mamba2_370m, minicpm3_4b,
                                 moonshot_v1_16b_a3b, opt_125m,
                                 recurrentgemma_2b, yi_6b)
from repro_torch.configs.base import ModelConfig

_ARCHS = {"opt-125m": opt_125m.build, "mamba2-370m": mamba2_370m.build,
          "recurrentgemma-2b": recurrentgemma_2b.build, "yi-6b": yi_6b.build,
          "minicpm3-4b": minicpm3_4b.build,
          "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.build,
          "deepseek-v2-236b": deepseek_v2_236b.build,
          "granite-34b": granite_34b.build,
          "deepseek-coder-33b": deepseek_coder_33b.build}


def list_archs() -> list:
    return sorted(_ARCHS)


def get_arch(arch_id: str) -> ModelConfig:
    try:
        return _ARCHS[arch_id]()
    except KeyError:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported (ROADMAP A8: other families); "
            f"available: {list_archs()}") from None
