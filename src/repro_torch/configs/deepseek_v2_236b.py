"""deepseek-v2-236b [moe] — MLA with 2 shared and 160 routed experts
top-6, as `repro.configs.deepseek_v2_236b` defines it (arXiv:2405.04434):
60 layers, d_model 5120, 128 heads, vocab 102400; MLA kv_lora_rank 512,
q_lora_rank 1536, qk_nope 128 + qk_rope 64 (a q·k head of 192), v_head
128; d_expert 1536. All 60 layers are MoE (the reference keeps them
uniform for its scan over layers). 2.39e11 parameters, 957.5 GB in f32:
one 80 GB card holds two of its layers.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        head_dim=128,
        moe=MoEConfig(n_experts=160, n_experts_per_tok=6,
                      n_shared_experts=2, d_expert=1536),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
    )


register_arch("deepseek-v2-236b", build)
