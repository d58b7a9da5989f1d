"""Config dataclasses, copied field for field from `repro.configs.base`.

Only the classes the ported slice reads are here; names and defaults match
the reference so a config built for one package reads the same in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    n_experts_per_tok: int = 0      # top-k
    n_shared_experts: int = 0       # always-on experts (deepseek-style)
    d_expert: int = 0               # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    chunk: int = 256                # dispatch-group length (bounds transients)

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block config."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style temporal-mixing pattern."""
    pattern: str = ""
    lru_width: int = 0
    local_window: int = 2048
    conv1d_width: int = 4

    @property
    def enabled(self) -> bool:
        return bool(self.pattern)


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub (vision / audio embeddings)."""
    kind: str = "none"              # none | vision | audio
    n_frontend_tokens: int = 0
    d_frontend: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads
    n_encoder_layers: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    subquadratic: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (the dense, ssm
        and hybrid fields as in `repro`; the other families are not ported
        yet)."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            n_encoder_layers=min(self.n_encoder_layers, 2),
        )
        if self.ssm.enabled:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2,
                                  head_dim=16, chunk=32)
        if self.hybrid.enabled:
            kw["hybrid"] = HybridConfig(pattern=self.hybrid.pattern,
                                        lru_width=64, local_window=32,
                                        conv1d_width=4)
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# pAirZero configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ZOConfig:
    mu: float = 1e-3                # perturbation scale (paper Sec. VII-A)
    lr: float = 5e-7                # selected analog lr (Table I)
    clip_gamma: float = 100.0       # projection clip γ (paper Sec. VII-D3)
    n_perturb: int = 1              # perturbation directions per round
    dual_mode: str = "sequential"   # sequential | stacked


@dataclass(frozen=True)
class ChannelConfig:
    """Wireless channel (paper Sec. III-B), realized by repro_torch.channel:
    a fading base (`model`) with the geometry, imperfect-CSI and outage
    wrappers its fields compose."""
    n0: float = 1.0                 # server noise power N0
    power: float = 100.0            # per-client power budget P
    fading: str = "rayleigh"        # DEPRECATED alias for `model`
    d: int = 1                      # model dimension (enters (C2) + SNR_max)
    model: Optional[str] = None     # channel-registry name; None → `fading`
    rician_k: float = 3.0
    ar1_rho: float = 0.9
    doppler_hz: Optional[float] = None
    round_duration_s: float = 1e-3
    phase_err_std: float = 0.0
    outage_db: Optional[float] = None
    cell_radius: float = 0.0
    pathloss_exp: float = 3.76
    shadow_std_db: float = 0.0
    shadow_corr: float = 0.5

    @property
    def snr_max(self) -> float:     # Eq. (37)
        return self.power / (self.d * self.n0)


@dataclass(frozen=True)
class DPConfig:
    epsilon: float = 5.0
    delta: float = 0.01
    enabled: bool = True


@dataclass(frozen=True)
class PowerControlConfig:
    scheme: str = "solution"        # solution | static | reversed | perfect
    contraction_a: float = 0.998    # A (analog) — paper Sec. VII-D2
    contraction_a_tilde: float = 0.998
    e0: float = 0.4960
    bisect_tol: float = 1e-10
    bisect_iters: int = 200


@dataclass(frozen=True)
class TransportConfig:
    """Which uplink mechanism carries the round (repro_torch.core.transport)."""
    mechanism: str = "analog"
    scheme: str = "solution"
    quant_bits: int = 8


@dataclass(frozen=True)
class PairZeroConfig:
    """Run config. `byzantine` and `desync` keep the reference's field names
    so configs line up; this port rejects any value but None."""
    variant: str = "analog"         # DEPRECATED: analog | sign | fo
    n_clients: int = 5
    rounds: int = 8000
    zo: ZOConfig = field(default_factory=ZOConfig)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    dp: DPConfig = field(default_factory=DPConfig)
    power: PowerControlConfig = field(default_factory=PowerControlConfig)
    transport: Optional[TransportConfig] = None
    byzantine: Optional[Any] = None
    desync: Optional[Any] = None
    seed: int = 0
    fused_perturbation: bool = False
