"""The pAirZero round (Algorithm 1), ported from `repro.core.pairzero`.

One round: for each of n_perturb directions, every client evaluates its
clipped projection p_k from the shared seed (the chained, fresh or fused
dual forward), the Transport recovers p̂ from the [K] payload vector, and
w ← w − η p̂ z is applied from the same seed. Round-varying control (c, σ,
N0, mask, CSI factors, the round's leaf seeds and noise normals) is data
on the device: the round body reads no host value and makes no host
tensor, so one captured CUDA graph replays any round
(`engine.ScanExecutor`). `make_fo_step` is the first-order baseline's
round. The reference's scenario options are ported: an eavesdropper's
capture (`adversary`), Byzantine behaviors and defenses, and desync; the
mesh is not (ROADMAP A11).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.byzantine import behaviors as byz_behaviors
from repro_torch.configs.base import ModelConfig, PairZeroConfig
from repro_torch.core import transport as tp
from repro_torch.core import zo
from repro_torch.models import registry
from repro_torch.obs import retrace
from repro_torch.runtime import desync as ds

#: metric-key prefix of an eavesdropper's observations (`privacy.OBS_PREFIX`)
OBS_PREFIX = "obs_"

Params = Dict


def make_loss_fn(model_cfg: ModelConfig) -> Callable[[Params, Dict],
                                                      torch.Tensor]:
    """Per-client loss vector [K] for this architecture."""
    mod = registry.get_module(model_cfg)

    def loss_fn(params: Params, batch: Dict) -> torch.Tensor:
        return mod.loss_per_client(params, model_cfg, batch)

    return loss_fn


def make_control(t: int, schedule, base_seed: int, n_clients: int,
                 n_perturb: int, device, n_leaves: int) -> Dict:
    """Round-t control block: the broadcast seed (a host int, for the
    record) plus device tensors c, sigma [K], n0, mask [K], g [K], noise
    [n_perturb, K+1] (one row of standard normals per perturbation
    direction, drawn from the reference's round key, fold_in(key(base_seed
    ^ 0x5EED), t): `engine.noise_rows`) and leaf_seeds [n_perturb,
    n_leaves] (int32 holding the uint32 leaf seeds, the row the round body
    reads per direction). A helper for single rounds, built on the host
    outside any round body."""
    from repro_torch.core.engine import noise_rows
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "seed": zo.round_seed(base_seed, t),
        "c": torch.tensor(np.float32(schedule.c[t]), **f32),
        "sigma": torch.tensor(np.asarray(schedule.sigma[t], np.float32),
                              **f32),
        "n0": torch.tensor(np.float32(schedule.n0), **f32),
        "mask": torch.ones(n_clients, **f32),
        "g": torch.ones(n_clients, **f32),
        "noise": torch.from_numpy(
            noise_rows(base_seed, t, t + 1, n_perturb, n_clients)[0]
        ).to(device),
        "leaf_seeds": torch.from_numpy(zo.seed_table(
            base_seed, t, t + 1, n_perturb, n_leaves)[0].view(np.int32)
        ).to(device),
    }


@functools.lru_cache(maxsize=128)
def make_zo_step(model_cfg: ModelConfig, pz: PairZeroConfig,
                 transport: Optional[tp.Transport] = None,
                 adversary=None, behavior=None, defense=None,
                 desync=None) -> Callable:
    """step(params, batch, ctl) → (params, metrics) for one round.

    `params` is updated in place and returned. Memoized on the (frozen)
    configs and scenario objects, as the reference's is, so identical runs
    share one step and the scan engine's cached graph
    (`engine.get_executor`).

    Each direction j runs the reference's chain: under `desync` (a
    `runtime.desync.DesyncModel`) first a fresh-mode dual forward on the
    lagged seed's leaf seeds ctl["dsync_leaf_seeds"][j] (w untouched),
    then the main dual forward; the projection, the stale clients'
    projection in its place (`desync.stale_payload`), `behavior` (a
    `byzantine.ClientBehavior`, gated by ctl["byz"]), `defense.transmit`,
    then `defense.aggregate` or the transport's; then the update. An
    `adversary` (`privacy.Adversary`) adds what the eavesdropper records
    on direction 0 (`obs_*`), from the same payloads and draw rows as the
    decode: capture is passive. None for each is the historical round."""
    retrace.bump(retrace.ZO_STEP_BUILD)     # lru miss: a fresh step build
    loss_fn = make_loss_fn(model_cfg)
    transport = transport if transport is not None else tp.resolve(pz)
    mu, lr, gamma = pz.zo.mu, pz.zo.lr, pz.zo.clip_gamma
    n_perturb = pz.zo.n_perturb
    if pz.fused_perturbation:
        # fused dual forward: z regenerated inside the layer kernels
        # (zo.tag_perturbed); the reference wires it for the transformer
        # families only (dense and moe: MLA's wkv_b and the expert banks
        # resolve to per-layer transients)
        if model_cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"fused_perturbation supports the dense/moe families; "
                f"{model_cfg.name!r} is family {model_cfg.family!r} "
                "(its layer stack has consumers without a fused path)")
        mode = "fused"
    else:
        mode = "chained" if pz.zo.dual_mode in ("chained", "sequential") \
            else "fresh"

    # the rows the round reads per direction
    per_direction = tuple(transport.draws) + (
        tuple(behavior.draws) if behavior is not None else ()) + (
        tuple(defense.draws(transport)) if defense is not None else ())

    def round_body(params: Params, batch: Dict, ctl: Dict
                   ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        metrics = {}
        p_hat_sum = 0.0
        loss_acc = 0.0
        for j in range(n_perturb):
            seeds = ctl["leaf_seeds"][j]          # device row, no host read
            ctl_j = {**ctl, **{k: ctl[k][j] for k in per_direction}}
            if desync is not None:
                # the stale clients' lagged seed: a fresh-mode dual forward
                # before the main (possibly in-place) walk
                lp_s, lm_s, _ = zo.dual_forward(
                    lambda p: loss_fn(p, batch), params,
                    ctl["dsync_leaf_seeds"][j], mu, mode="fresh")
            lp, lm, params_at = zo.dual_forward(
                lambda p: loss_fn(p, batch), params, seeds, mu, mode=mode)
            p_k = zo.projection(lp, lm, mu, gamma)                 # [K]
            if desync is not None:
                p_k = ds.stale_payload(
                    p_k, zo.projection(lp_s, lm_s, mu, gamma), ctl)
            if behavior is not None:
                p_k = byz_behaviors.apply_behavior(behavior, p_k, ctl_j)
            if defense is not None:
                p_k = defense.transmit(p_k, ctl_j)
                p_hat = defense.aggregate(transport, p_k, ctl_j)
            else:
                p_hat = transport.aggregate(p_k, ctl_j)
            # restore + update fused into one axpy (chained mode)
            params = zo.apply_update(params_at, seeds, p_hat,
                                     lr / n_perturb, mu, mode=mode)
            p_hat_sum = p_hat_sum + p_hat
            loss_acc = loss_acc + torch.mean(0.5 * (lp + lm))
            if j == 0:
                metrics["p_clients"] = p_k
                if adversary is not None:
                    metrics.update(adversary.observe(transport, p_k, ctl_j))
        metrics["loss"] = loss_acc / n_perturb
        metrics["p_hat"] = p_hat_sum / n_perturb
        metrics["k_eff"] = torch.sum(ctl["mask"])
        return params, metrics

    return round_body


@functools.lru_cache(maxsize=128)
def make_fo_step(model_cfg: ModelConfig, optimizer, adversary=None,
                 desync=None) -> Callable:
    """The first-order FedSGD/Adam baseline's round: full backprop and
    cross-client gradient averaging (the d-dimensional uplink the paper
    eliminates). step((params, opt_state), batch, ctl) → ((params,
    opt_state), metrics); both are updated in place and returned.

    The loss is the mask-weighted mean of the per-client losses over
    max(Σ mask, 1); its gradient comes from `torch.autograd.grad` over the
    leaves in `zo.flatten` order (the reference's), then
    `optimizer.update`. The kernels' forwards run as on the ZO paths; their
    backward recomputes the plain versions (`kernels.ops`). Metrics: the
    loss, and k_eff (Σ mask) as the ZO round reports it. Memoized on the
    (frozen) config and optimizer, so identical runs share one step and
    the scan engine's cached graph.

    `desync` degrades the decoded gradient as a conventional d-symbol
    analog frame: per-coordinate frame gains (`desync.conventional_frame`),
    then the lost energy as interference (`desync.conventional_ici`, its
    normals drawn on the device from ctl["dsync_ici_keys"], its scale from
    the gradient before framing); both in place on the gradient, the loss
    metric untouched. `adversary` adds the FO uplink's leak, client 0's
    own gradient `obs_grad0` (flat f32, leaves in `zo.flatten` order):
    after the round's backward, a second forward and backward over client
    0's rows of the batch alone (its loss reads no other client's rows),
    so the first backward frees its activations as it goes and the second
    holds a fifth of them; the reference differentiates client 0's entry
    of the whole batch's losses, the same function. None for each is the
    historical round, bit for bit."""
    retrace.bump(retrace.FO_STEP_BUILD)     # lru miss: a fresh step build
    loss_fn = make_loss_fn(model_cfg)

    def step(state, batch: Dict, ctl: Dict):
        params, opt_state = state
        leaves = [t.detach().requires_grad_(True)
                  for _, t in zo.flatten(params)]
        tracked = zo.rebuild(params, leaves)
        mask = ctl["mask"]
        metrics = {}
        with torch.enable_grad():
            per_client = loss_fn(tracked, batch)                  # [K]
            loss = torch.sum(per_client * mask) / torch.clamp_min(
                torch.sum(mask), 1.0)
            grads = torch.autograd.grad(loss, leaves)
            if adversary is not None:
                own = loss_fn(tracked, {k: v[:1] for k, v in batch.items()})
                g0 = torch.autograd.grad(own[0], leaves)
                metrics[OBS_PREFIX + "grad0"] = torch.cat(
                    [g.reshape(-1).to(torch.float32) for g in g0])
                del own, g0
        grads = zo.rebuild(params, list(grads))
        if desync is not None:
            rms = ds.ici_rms(grads)
            ds.conventional_frame(grads, ctl, desync.frame_symbols)
            ds.conventional_ici(grads, ctl, ctl["dsync_ici_keys"], rms)
        params, opt_state = optimizer.update(params, grads, opt_state)
        metrics.update(loss=loss.detach(), k_eff=torch.sum(mask))
        return (params, opt_state), metrics

    return step
