"""OPT-125M — the paper's own experimental model (arXiv:2205.01068), as
`repro.configs.opt_125m` defines it (rotary positions instead of OPT's
learned absolute embeddings)."""
from repro_torch.configs.base import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="opt-125m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=50272,
        head_dim=64,
    )
