"""mamba2-370m [ssm] — SSD (state-space duality), attention-free, as
`repro.configs.mamba2_370m` defines it (arXiv:2405.21060).

expand=2 → d_inner=2048, head_dim=64 → 32 SSD heads, d_conv=4, ngroups=1.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
        subquadratic=True,
        tie_embeddings=True,
    )
