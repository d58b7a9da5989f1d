"""Configs and the architecture registry: importing this package registers
every architecture (`models.arch_registry`), as `repro.configs` does."""
from repro_torch.configs import (  # noqa: F401
    deepseek_coder_33b, deepseek_v2_236b, granite_34b, internvl2_76b,
    mamba2_370m, minicpm3_4b, moonshot_v1_16b_a3b, opt_125m,
    recurrentgemma_2b, whisper_medium, yi_6b)
from repro_torch.configs.base import ModelConfig
from repro_torch.models.arch_registry import arch_builder, registered


def list_archs() -> list:
    return registered()


def get_arch(arch_id: str) -> ModelConfig:
    """The config registered under `arch_id` (ValueError naming the
    registered ids otherwise)."""
    return arch_builder(arch_id)()
