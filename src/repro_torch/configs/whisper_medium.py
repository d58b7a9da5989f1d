"""whisper-medium [audio] — encoder-decoder with a conv frontend (stub), as
`repro.configs.whisper_medium` defines it (arXiv:2212.04356): 24 encoder
and 24 decoder layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab
51865, the decoder's embedding tied to its head; 959.2 M parameters, 3.84
GB in f32.

The conv frontend is a stub, as in the reference: the data pipeline
supplies 1500 precomputed frame embeddings (30 s of audio) at d_model.
Like the reference, the blocks are RMSNorm, SwiGLU and roped self-
attention without biases, not Hugging Face's whisper.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig
from repro_torch.models.arch_registry import register_arch


def build() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,
        n_encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        head_dim=64,
        frontend=FrontendConfig(kind="audio", n_frontend_tokens=1500,
                                d_frontend=1024),
        tie_embeddings=True,
    )


register_arch("whisper-medium", build)
