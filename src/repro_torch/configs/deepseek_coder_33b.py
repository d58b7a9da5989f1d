"""deepseek-coder-33b [dense] — llama-arch GQA, as
`repro.configs.deepseek_coder_33b` defines it (arXiv:2401.14196): 62
layers, d_model 7168, 56 heads of 128 on 8 kv heads, d_ff 19200, vocab
32256. 3.33e10 parameters, 133.4 GB in f32: it does not fit one 80 GB
card and runs `--reduced` only.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        head_dim=128,
    )


register_arch("deepseek-coder-33b", build)
