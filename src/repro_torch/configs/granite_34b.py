"""granite-34b [dense] — llama-arch MQA (one kv head), a code model, as
`repro.configs.granite_34b` defines it (arXiv:2405.04324): 88 layers,
d_model 6144, 48 heads of 128, d_ff 24576, vocab 49152. 4.72e10
parameters, 189.0 GB in f32: it does not fit one 80 GB card and runs
`--reduced` only.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        head_dim=128,
    )


register_arch("granite-34b", build)
