"""Config dataclasses, copied field for field from `repro.configs.base`.

Only the classes the ported slice reads are here; names and defaults match
the reference so a config built for one package reads the same in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


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
        """A tiny same-family variant for CPU smoke tests, as `repro`'s
        (the vlm and audio frontends cut to 8 embeddings of 64)."""
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
        if self.moe.enabled:
            kw["moe"] = MoEConfig(
                n_experts=4, n_experts_per_tok=2,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_expert=64)
        if self.mla.enabled:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.ssm.enabled:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2,
                                  head_dim=16, chunk=32)
        if self.hybrid.enabled:
            kw["hybrid"] = HybridConfig(pattern=self.hybrid.pattern,
                                        lru_width=64, local_window=32,
                                        conv1d_width=4)
        if self.frontend.kind != "none":
            kw["frontend"] = FrontendConfig(kind=self.frontend.kind,
                                            n_frontend_tokens=8,
                                            d_frontend=64)
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


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
class ByzantineConfig:
    """Active-adversary scenario (repro_torch.byzantine): who attacks, how
    many, and what the server defends with.

    `behavior` names a registered ClientBehavior (sign_flip | scaled_poison
    | gaussian_noise | colluding_cohort | "none"); `fraction` is the share
    of clients running it (0.0 disables the attack: the run is the one
    without a ByzantineConfig, bit for bit). `defense` names a registered
    Defense (clip | robust_decode | reweight | "none"). `scale` is the
    behavior's parameter (λ for scaled_poison, the noise std for
    gaussian_noise); `groups` the robust defenses' decode sub-slots;
    `clip_factor` the transmit clip γ_d = clip_factor·γ. `seed` salts the
    cohort draw."""
    behavior: str = "none"
    fraction: float = 0.0
    scale: float = 3.0
    defense: str = "none"
    groups: int = 4
    clip_factor: float = 0.5
    seed: int = 0


@dataclass(frozen=True)
class DesyncConfig:
    """Client synchronization-failure scenario (repro_torch.runtime.desync).

    `fraction` is the per-round probability a client is stale (its scalar
    rides z_{t−d}, the shared lag d uniform in [1, `max_lag`]);
    `phase_std` the std (radians) of each client's persistent timing/phase
    error (the scalar payload attenuated by cos θ; the conventional
    d-symbol frame of `frame_symbols` symbols collapses along the
    Dirichlet kernel). `seed` salts the draws. fraction 0 with phase_std 0
    (or no DesyncConfig) is the synchronized run, bit for bit."""
    fraction: float = 0.0
    max_lag: int = 4
    phase_std: float = 0.0
    frame_symbols: int = 1
    seed: int = 0


@dataclass(frozen=True)
class PairZeroConfig:
    """Run config, field for field the reference's: `byzantine` and
    `desync` (None: the honest, synchronized run) resolve through
    `repro_torch.byzantine` and `repro_torch.runtime.desync`."""
    variant: str = "analog"         # DEPRECATED: analog | sign | fo
    n_clients: int = 5
    rounds: int = 8000
    zo: ZOConfig = field(default_factory=ZOConfig)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    dp: DPConfig = field(default_factory=DPConfig)
    power: PowerControlConfig = field(default_factory=PowerControlConfig)
    transport: Optional[TransportConfig] = None
    byzantine: Optional[ByzantineConfig] = None
    desync: Optional[DesyncConfig] = None
    seed: int = 0
    fused_perturbation: bool = False
