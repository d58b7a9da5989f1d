"""minicpm3-4b [dense] — MLA attention, as `repro.configs.minicpm3_4b`
defines it ([hf:openbmb/MiniCPM3-4B]): 62 layers, d_model 2560, 40
heads, d_ff 6400, vocab 73448; MLA kv_lora_rank 256, q_lora_rank 768,
qk_nope 64 + qk_rope 32 (a q·k head of 96), v_head 64. 4.26e9
parameters, 17.05 GB in f32.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        head_dim=64,
        mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
    )


register_arch("minicpm3-4b", build)
