"""moonshot-v1-16b-a3b [moe] — kimi/moonlight family, as
`repro.configs.moonshot_v1_16b_a3b` defines it
([hf:moonshotai/Moonlight-16B-A3B]): 48 layers, d_model 2048, 16 heads of
128, every layer routed MoE with 64 experts top-6 of d_expert 1408 (d_ff
is the per-expert width), no shared experts, vocab 163840. 2.81e10
parameters, 112.2 GB in f32: one 80 GB card holds it only with its depth
cut.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        head_dim=128,
        moe=MoEConfig(n_experts=64, n_experts_per_tok=6,
                      n_shared_experts=0, d_expert=1408),
    )


register_arch("moonshot-v1-16b-a3b", build)
