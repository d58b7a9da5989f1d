"""recurrentgemma-2b [hybrid] — RG-LRU recurrent blocks and local
attention in a 2:1 pattern, as `repro.configs.recurrentgemma_2b` defines
it (arXiv:2402.19427).

Pattern (r, r, a) cycled: 26 = 8×(r,r,a) + (r,r). lru_width=2560, local
window=2048, head_dim=256 (10 heads × 256 = 2560, one kv head).
"""
from repro_torch.configs.base import HybridConfig, ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        hybrid=HybridConfig(pattern="rra", lru_width=2560,
                            local_window=2048, conv1d_width=4),
        subquadratic=True,
        tie_embeddings=True,
    )


register_arch("recurrentgemma-2b", build)
