"""Privacy subsystem, ported from `repro.privacy`: the adversary, the
attacks and the empirical DP audit.

  adversary   `Adversary.observe` delegates to the round Transport's
              `observe` (the same draw rows as the decode), so both
              engines capture what an over-the-air listener sees, as
              `obs_*` metrics, without moving the trajectory;
  attacks     `seed_replay` (the ZO threat: replay the public seed,
              estimate the scalar through the Eq.-16 noise), `steering`
              (what a Byzantine cohort changes), `dlg` (gradient
              inversion of a raw-gradient uplink);
  audit       paired canary traces on the device → a Clopper–Pearson ε̂
              lower bound, held under the accountant's
              `dp.epsilon_for_budget`;
  hooks       `AttackHook`, which stacks the captured observations.
"""
from repro_torch.privacy.adversary import OBS_PREFIX, Adversary
from repro_torch.privacy.attacks import (Attack, GradientInversion,
                                         SeedReplayAttack,
                                         TrajectorySteering, available,
                                         client_gradient, get,
                                         reconstruction_error, register,
                                         zo_gradient_estimate)
from repro_torch.privacy.audit import (AuditResult, audit_transport,
                                       clopper_pearson_upper,
                                       paired_trace_statistics)
from repro_torch.privacy.hooks import AttackHook

__all__ = [
    "OBS_PREFIX", "Adversary", "Attack", "AttackHook", "AuditResult",
    "GradientInversion", "SeedReplayAttack", "TrajectorySteering",
    "audit_transport",
    "available", "client_gradient", "clopper_pearson_upper", "get",
    "paired_trace_statistics", "reconstruction_error", "register",
    "zo_gradient_estimate",
]
