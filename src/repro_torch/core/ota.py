"""Over-the-air computation (paper Sec. III-B, IV-B), ported from
`repro.core.ota`.

The receiver observes y = c Σ_k w_k (p_k + n_k) + z (Eq. 4) and inverts
p̂ = y / (K_eff c) (Eq. 5). The noise is data: `noise` holds K+1 standard
normals for the round — the K artificial-noise draws, then the receiver
noise — made by the control trace (`core.engine.build_trace`). A robust
defense's sub-slots each read their own row, made from the reference's
`subslot_keys`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import prng


def superpose(p: torch.Tensor, c: torch.Tensor, sigma: torch.Tensor,
              n0: torch.Tensor, noise: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              g: Optional[torch.Tensor] = None,
              a: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw RF observation y (Eq. 4) and the surviving client count.

    `noise` is [..., K+1] standard normals: n_k = σ_k·noise[..., :K], z =
    √N0·noise[..., K] (leading dims, as the audit's trials × rounds, give
    a y for each). `g` is the per-client cos θ CSI factor (None = perfect
    CSI); `a` the desync trace's timing/phase attenuation (None =
    synchronized, the historical program)."""
    k_clients = p.shape[-1]
    if mask is None:
        mask = torch.ones(k_clients, dtype=p.dtype, device=p.device)
    mask = mask.to(p.dtype)
    n_k = sigma.to(p.dtype) * noise[..., :k_clients]
    z = torch.sqrt(n0).to(p.dtype) * noise[..., k_clients]
    w = mask if g is None else mask * g.to(p.dtype)
    if a is not None:
        w = w * a.to(p.dtype)
    y = c * torch.sum(w * (p + n_k), dim=-1) + z
    k_eff = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    return y, k_eff


def analog_ota(p: torch.Tensor, c: torch.Tensor, sigma: torch.Tensor,
               n0: torch.Tensor, noise: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               g: Optional[torch.Tensor] = None,
               a: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analog pAirZero uplink (Eqs. 8–9) + channel inversion (Eq. 5).

    c == 0 is a silent round: nobody transmits and p̂ = 0."""
    y, k_eff = superpose(p, c, sigma, n0, noise, mask, g, a)
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    p_hat = torch.where(c > 0, y / (k_eff * safe_c), torch.zeros_like(y))
    return p_hat, k_eff


def sign_ota(p: torch.Tensor, c: torch.Tensor, sigma: torch.Tensor,
             n0: torch.Tensor, noise: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             g: Optional[torch.Tensor] = None,
             a: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-pAirZero uplink (Eq. 11): clients transmit sign{p_k} + n_k and
    the server inverts by (K_eff c) as in the analog case. torch.sign of an
    exact 0 is 0, as jnp.sign's is."""
    return analog_ota(torch.sign(p), c, sigma, n0, noise, mask, g, a)


def perfect_analog(p: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noise-free upper-bound baseline (Eq. 38): the surviving clients'
    mean."""
    if mask is None:
        return torch.mean(p)
    mask = mask.to(p.dtype)
    return torch.sum(mask * p) / torch.clamp_min(torch.sum(mask), 1.0)


def perfect_sign(p: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noise-free majority vote (Eq. 39): sign{Σ_k sign{p_k}}."""
    if mask is None:
        mask = torch.ones_like(p)
    return torch.sign(torch.sum(mask.to(p.dtype) * torch.sign(p)))


def effective_noise_std(c: torch.Tensor, sigma: torch.Tensor,
                        n0: torch.Tensor) -> torch.Tensor:
    """m(t) = sqrt(c² Σ_k σ_k² + N0)  (Eq. 12)."""
    return torch.sqrt(c * c * torch.sum(sigma * sigma) + n0)


#: fold_in tag deriving per-sub-slot noise keys from the round key
SUBSLOT_TAG = 0x51B5


def subslot_keys(key: torch.Tensor, slots: int) -> torch.Tensor:
    """[..., slots, 2] keys fold_in(key, 0x51B5 + s) of a robust decode's
    sub-slots (`repro.core.ota.subslot_keys`), for keys [..., 2]."""
    tags = torch.arange(SUBSLOT_TAG, SUBSLOT_TAG + slots)
    return prng.fold_in(key[..., None, :], tags)
