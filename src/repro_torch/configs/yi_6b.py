"""yi-6b [dense] — llama-arch GQA, as `repro.configs.yi_6b` defines it
(arXiv:2403.04652): 32 layers, d_model 4096, 32 heads of 128 on 4 kv
heads, d_ff 11008, vocab 64000; 6.06e9 parameters, 24.2 GB in f32.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        head_dim=128,
    )


register_arch("yi-6b", build)
