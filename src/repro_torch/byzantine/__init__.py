"""Byzantine robustness, ported from `repro.byzantine`: active-adversary
behaviors (`behaviors`: which clients attack, and how their payload is
rewritten before the Transport's aggregate) and OTA-compatible defenses
(`defenses`: a transmit clip folded into the power-control solve, and
median or residual-reweighted decodes over orthogonal sub-slots). Two
registries of frozen dataclasses, as the reference's; `resolve_*` return
None for an absent, "none" or zero-fraction scenario, and the round is
then the historical one, bit for bit.
"""
from repro_torch.byzantine.behaviors import (
    BYZ_KEY_TAG,
    ClientBehavior,
    ColludingCohort,
    GaussianNoise,
    ScaledPoison,
    SignFlip,
    apply_behavior,
)
from repro_torch.byzantine.behaviors import available as available_behaviors
from repro_torch.byzantine.behaviors import get as get_behavior
from repro_torch.byzantine.behaviors import register as register_behavior
from repro_torch.byzantine.behaviors import resolve as resolve_behavior
from repro_torch.byzantine.defenses import (
    Defense,
    ResidualReweight,
    RobustDecode,
    TransmitClip,
)
from repro_torch.byzantine.defenses import available as available_defenses
from repro_torch.byzantine.defenses import get as get_defense
from repro_torch.byzantine.defenses import register as register_defense
from repro_torch.byzantine.defenses import resolve as resolve_defense

__all__ = [
    "BYZ_KEY_TAG",
    "ClientBehavior",
    "SignFlip",
    "ScaledPoison",
    "GaussianNoise",
    "ColludingCohort",
    "apply_behavior",
    "available_behaviors",
    "get_behavior",
    "register_behavior",
    "resolve_behavior",
    "Defense",
    "TransmitClip",
    "RobustDecode",
    "ResidualReweight",
    "available_defenses",
    "get_defense",
    "register_defense",
    "resolve_defense",
]
