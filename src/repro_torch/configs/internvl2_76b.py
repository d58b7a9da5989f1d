"""internvl2-76b [vlm] — InternViT frontend (stub) + a llama-3-70B-class
LM, as `repro.configs.internvl2_76b` defines it (arXiv:2404.16821): 80
layers, d_model 8192, 64 heads of 128 on 8 kv heads, d_ff 28672, vocab
128256; 282 GB of f32 weights over its 80 layers.

The modality frontend is a stub, as in the reference: the data pipeline
supplies 256 precomputed patch embeddings per sample at d_model, prepended
to the text sequence.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        head_dim=128,
        frontend=FrontendConfig(kind="vision", n_frontend_tokens=256,
                                d_frontend=8192),
    )


register_arch("internvl2-76b", build)
