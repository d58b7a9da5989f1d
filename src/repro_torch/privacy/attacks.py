"""Attack registry: seed replay, trajectory steering and DLG gradient
inversion, ported from `repro.privacy.attacks`.

  seed_replay  the ZO threat: the round seed is broadcast in the clear,
               so a listener replays z(seed) and needs only the scalar.
               Against the digital uplinks each client's scalar arrives
               exact; against the OTA superposition only a noisy sum,
               p̃ = y / (K_eff c). Host numpy, as the reference's.
  steering     scores an active cohort by what it changes in the loss
               trajectory (and a defense by the gap it recovers).
  dlg          DLG-style gradient inversion [Zhu et al. 2019] against a
               raw-gradient uplink: a dummy input (embeddings, or soft
               tokens) optimized with Adam until the gradient it induces
               matches the observed one (cosine or l2), tokens read back
               off it. The induced gradient is differentiated again, so
               the model's kernels run with a differentiable vjp
               (`kernels.ops._KernelWithPlainVjp`); the steps run eagerly
               on the params' device.

`client_gradient`, `zo_gradient_estimate` and `reconstruction_error` are
the shared scoring oracle: a flat f32 gradient estimate against one
client's true gradient, ‖ĝ − g‖ / ‖g‖.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Type

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import zo
from repro_torch.kernels import ops as kops
from repro_torch.optim import fo as fo_opt

_REGISTRY: Dict[str, Type["Attack"]] = {}


def register(name: str):
    """Class decorator adding an Attack under `name`."""
    def deco(cls: Type["Attack"]) -> Type["Attack"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available() -> tuple:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type["Attack"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown attack {name!r} "
                         f"(registered: {available()})") from None


@dataclass(frozen=True)
class Attack:
    """One reconstruction attack. Subclass + `@register(name)`."""

    name = "?"

    def run(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _tracked(params):
    """(the tree with fresh leaves that require grad, those leaves)."""
    leaves = [t.detach().requires_grad_(True) for _, t in zo.flatten(params)]
    return zo.rebuild(params, leaves), leaves


def client_gradient(model_cfg, params, batch: Dict,
                    client: int = 0) -> torch.Tensor:
    """Flat f32 first-order gradient of one client's loss (leaves in
    `zo.flatten` order): the ground truth every reconstruction is scored
    against, and what the FO uplink radiates for that client."""
    from repro_torch.core.pairzero import make_loss_fn
    loss_fn = make_loss_fn(model_cfg)
    tracked, leaves = _tracked(params)
    with torch.enable_grad():
        g = torch.autograd.grad(loss_fn(tracked, batch)[client], leaves)
    return _flat(g)


def zo_gradient_estimate(params, seed, scalar) -> torch.Tensor:
    """Seed-replay gradient estimate ĝ = p̃ · z(seed), flat f32: z is
    drawn leaf by leaf from the direction seed `seed` (the public
    broadcast), bitwise the training streams (`seeded_axpy` on zeros)."""
    leaves = [t for _, t in zo.flatten(params)]
    seeds = zo.seed_row(int(seed), len(leaves), leaves[0].device)
    one = torch.ones((), dtype=torch.float32, device=leaves[0].device)
    z = [kops.seeded_axpy(torch.zeros_like(t, dtype=torch.float32),
                          seeds[i], one) for i, t in enumerate(leaves)]
    return float(np.float32(scalar)) * _flat(z)


def reconstruction_error(g_hat, g_true) -> float:
    """Relative reconstruction error ‖ĝ − g‖ / ‖g‖ in float64 (0: a
    perfect inversion)."""
    g_hat = np.asarray(_host(g_hat), dtype=np.float64)
    g_true = np.asarray(_host(g_true), dtype=np.float64)
    denom = float(np.linalg.norm(g_true))
    return float(np.linalg.norm(g_hat - g_true)) / max(denom, 1e-30)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


@register("seed_replay")
@dataclass(frozen=True)
class SeedReplayAttack(Attack):
    """Estimate the transmitted projection from the uplink observation:
    p̃ = y / (K_eff c) for the OTA "y" stream (the mean only, through the
    Eq.-16 noise), each client's q_k for the digital "q" stream (exact to
    the quantizer)."""
    victim: int = 0

    def run(self, observations: Dict[str, np.ndarray],
            payloads: np.ndarray, c: np.ndarray,
            k_eff: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Score scalar reconstruction over a captured horizon.
        `payloads` [T, K] are the payloads as transmitted
        (`Transport.transmitted`), `c` the schedule's gains, `k_eff` the
        surviving counts [T]."""
        payloads = np.asarray(payloads, dtype=np.float64)
        rounds, k = payloads.shape
        c = np.asarray(c, dtype=np.float64)[:rounds]
        k_eff = np.full(rounds, float(k)) if k_eff is None \
            else np.asarray(k_eff, dtype=np.float64)[:rounds]
        mean_true = payloads.mean(axis=1)
        out: Dict[str, Any] = {"rounds": rounds}

        if "obs_q" in observations:                  # digital: per client
            q = np.asarray(observations["obs_q"], dtype=np.float64)[:rounds]
            # a live slot never quantizes to exactly 0 (the 2^b − 1-level
            # grid over [−clip, clip] has an even number of points)
            est_mean = q.sum(axis=1) / np.maximum(k_eff, 1.0)
            live = q[:, self.victim] != 0.0
            err_v = q[live, self.victim] - payloads[live, self.victim]
            out["victim_rmse"] = float(np.sqrt(np.mean(err_v ** 2))) \
                if live.any() else float("inf")
            out["per_client_exposed"] = True
        elif "obs_y" in observations:                # OTA: noisy sum only
            y = np.asarray(observations["obs_y"], dtype=np.float64)[:rounds]
            active = c > 0
            est_mean = np.where(active, y / (k_eff * np.where(active, c, 1.0)),
                                0.0)
            err_v = est_mean - payloads[:, self.victim]
            out["victim_rmse"] = float(np.sqrt(np.mean(err_v[active] ** 2))) \
                if active.any() else float("inf")
            out["per_client_exposed"] = False
        else:
            raise ValueError(f"no usable observation stream in "
                             f"{sorted(observations)} (want obs_y or obs_q)")

        err_m = est_mean - mean_true
        out["mean_rmse"] = float(np.sqrt(np.mean(err_m ** 2)))
        out["mean_corr"] = float(np.corrcoef(est_mean, mean_true)[0, 1]) \
            if rounds > 1 and np.std(est_mean) > 0 and np.std(mean_true) > 0 \
            else 0.0
        out["estimates"] = est_mean
        return out


@register("steering")
@dataclass(frozen=True)
class TrajectorySteering(Attack):
    """Score an active adversary by its loss trajectory against a clean
    one: steering_rmse, final_gap over the last `tail` rounds, and the
    defense's gap_recovery (None without a defended series or an attack
    that did not move the tail)."""
    tail: int = 10

    def run(self, clean, attacked, defended=None) -> Dict[str, Any]:
        clean = np.asarray(clean, dtype=np.float64)
        attacked = np.asarray(attacked, dtype=np.float64)
        rounds = min(len(clean), len(attacked))
        if rounds == 0:
            raise ValueError("steering needs non-empty loss series")
        t = min(self.tail, rounds)
        clean, attacked = clean[:rounds], attacked[:rounds]
        gap = float(attacked[-t:].mean() - clean[-t:].mean())
        out: Dict[str, Any] = {
            "rounds": rounds,
            "steering_rmse": float(np.sqrt(np.mean(
                (attacked - clean) ** 2))),
            "final_gap": gap,
            "gap_recovery": None,
        }
        if defended is not None and abs(gap) > 1e-12:
            defended = np.asarray(defended, dtype=np.float64)[:rounds]
            out["gap_recovery"] = float(
                (attacked[-t:].mean() - defended[-t:].mean()) / gap)
        return out


@register("dlg")
@dataclass(frozen=True)
class GradientInversion(Attack):
    """Iterative gradient matching: recover the victim's tokens from an
    observed gradient with `steps` Adam steps on a dummy input, from
    0.02 · normal(key(seed), (b, S, dim)) (the reference's draw).
    space="embed": dummy embeddings, cosine matching [Geiping et al.
    2020], tokens by the nearest embedding row; space="token": soft-token
    logits, softmax(D) @ W_embed, tokens by argmax. Targets and mask are
    known (iDLG)."""
    steps: int = 600
    lr: float = 0.02
    seed: int = 0
    space: str = "embed"        # embed | token
    objective: str = "cosine"   # cosine | l2

    def run(self, model_cfg, params, g_star, targets, mask,
            true_tokens=None) -> Dict[str, Any]:
        """Invert a flat observed gradient for one client's [b, S] batch,
        on the params' device."""
        if model_cfg.family != "dense":
            raise NotImplementedError(
                "gradient inversion drives the dense-transformer "
                f"embedding path; got family={model_cfg.family!r}")
        if self.space not in ("embed", "token"):
            raise ValueError(f"unknown search space: {self.space!r}")
        from repro_torch.models import transformer as tf
        dev = params["embed"]["w"].device
        targets = torch.as_tensor(np.asarray(targets), device=dev).long()
        lmask = torch.as_tensor(np.asarray(mask, np.float32), device=dev)
        b, s = targets.shape
        g_star = torch.tensor(np.asarray(_host(g_star), np.float32),
                              device=dev)
        w_embed = params["embed"]["w"].detach().to(torch.float32)

        def induced_gradient(x):
            tracked, leaves = _tracked(params)
            nll = tf.token_nll(tracked, model_cfg, None, targets, lmask,
                               inputs_embeds=x.to(w_embed.dtype))
            g = torch.autograd.grad(torch.mean(nll), leaves,
                                    create_graph=True, allow_unused=True)
            # a leaf off the path (an untied embedding table under
            # inputs_embeds) has a zero gradient, as jax.grad gives it
            return _flat(torch.zeros_like(t) if gi is None else gi
                         for gi, t in zip(g, leaves))

        def match_loss(dummy):
            x = torch.softmax(dummy, dim=-1) @ w_embed \
                if self.space == "token" else dummy
            g = induced_gradient(x)
            if self.objective == "l2":
                diff = g - g_star
                return torch.sum(diff * diff)
            cos = torch.sum(g * g_star) / (
                torch.linalg.vector_norm(g)
                * torch.linalg.vector_norm(g_star) + 1e-12)
            return 1.0 - cos

        def read_tokens(dummy):
            if self.space == "token":
                return torch.argmax(dummy, dim=-1)
            xn = dummy / (torch.linalg.vector_norm(
                dummy, dim=-1, keepdim=True) + 1e-12)
            wn = w_embed / (torch.linalg.vector_norm(
                w_embed, dim=-1, keepdim=True) + 1e-12)
            return torch.argmax(xn @ wn.T, dim=-1)

        opt = fo_opt.Adam(lr=self.lr)
        dim = model_cfg.vocab_size if self.space == "token" \
            else model_cfg.d_model
        state_tree = {"x": 0.02 * prng.normal(prng.key(self.seed, dev),
                                              (b, s, dim))}
        state = opt.init(state_tree)
        residuals = []
        with torch.enable_grad():
            for _ in range(self.steps):
                dummy = state_tree["x"].detach().requires_grad_(True)
                val = match_loss(dummy)
                grad, = torch.autograd.grad(val, dummy)
                residuals.append(val.detach())
                state_tree, state = opt.update(state_tree, {"x": grad},
                                               state)
        tokens_hat = read_tokens(state_tree["x"]).cpu().numpy()
        residuals = torch.stack(residuals).cpu().numpy()
        out: Dict[str, Any] = {
            "tokens": tokens_hat,
            "residuals": residuals,
            "final_residual": float(residuals[-1]),
        }
        if true_tokens is not None:
            true_tokens = np.asarray(true_tokens)
            out["token_accuracy"] = float(np.mean(tokens_hat == true_tokens))
            out["chance_accuracy"] = 1.0 / model_cfg.vocab_size
        return out
