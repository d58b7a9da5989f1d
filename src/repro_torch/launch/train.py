"""Training launcher: federated pAirZero fine-tuning on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
        --arch opt-125m --rounds 800 --clients 5 --engine scan

The ported subset of `repro.launch.train`'s flags, with its defaults: the
tasks (sst2, squad, lm), every transport (analog, sign, perfect, digital
and smart_digital with --quant-bits, and fo, the first-order FO-Adam
baseline; the deprecated --variant alias), the power-control schemes, every
channel model and its wrappers

    --channel rician --rician-k 4 --csi-phase-err 0.1 --outage-db -10 \
        --cell-radius 150

the loop and scan engines and the eval hook, checkpoints and resume

    --checkpoint-dir ckpt/ --checkpoint-every 100

(re-running the same command resumes from the newest valid checkpoint;
resuming a completed run executes no round), client faults and elastic
membership (--dropout-p, --straggler-p, --elastic 'round:K,...'), host
fault injection (--inject site:mode[:selector], --inject-seed), the
active adversary and its defenses

    --byzantine sign_flip --byzantine-frac 0.25 --defense robust_decode

client desync (--desync-frac, --desync-max-lag, --desync-phase-std,
--desync-frame-symbols), and `--audit`: the eavesdropper's capture, the
seed-replay attack on it and, on DP transports, the Clopper-Pearson ε̂
audit held under the analytic accountant (exit 1 if ε̂ exceeds it), the
observability flags

    --trace-out trace.json --metrics-out metrics.jsonl \
        --profile-out merged.json --health-policy abort

(the span timeline as Chrome trace-event JSON, the per-round trilemma
ledger, a torch.profiler capture merged onto the span timeline, and the
run-health monitor, which under `abort` checkpoints the last boundary and
exits with status 3; `tools/check_trace.py` checks the artifacts), plus
--device. Prints the reference's JSON summary keys that the port fills.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import byzantine as byz
from repro_torch import obs
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import (ByzantineConfig, ChannelConfig,
                                      DesyncConfig, DPConfig, PairZeroConfig,
                                      PowerControlConfig, TransportConfig,
                                      ZOConfig)
from repro_torch.core import fedsim, transport
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.data.tasks import TaskSpec
from repro_torch.runtime.fault import ElasticSchedule, FaultModel
from repro_torch.runtime.inject import FaultInjector


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="opt-125m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--task", default="sst2",
                    choices=["sst2", "squad", "lm"])
    ap.add_argument("--transport", default=None,
                    choices=list(transport.available()),
                    help="uplink mechanism from the transport registry; "
                         "default: --variant")
    ap.add_argument("--variant", default="analog",
                    choices=["analog", "sign", "fo"],
                    help="DEPRECATED alias for --transport")
    ap.add_argument("--scheme", default="solution",
                    choices=["solution", "static", "reversed", "perfect"],
                    help="power-control schedule for the OTA transports")
    ap.add_argument("--quant-bits", type=int, default=8,
                    help="bits/coordinate for --transport digital")
    ap.add_argument("--channel", default=None,
                    choices=["rayleigh", "rician", "static", "ar1"],
                    help="base fading model; default rayleigh. The "
                         "geometry/imperfect-CSI/outage wrappers compose "
                         "on top via --cell-radius/--csi-phase-err/"
                         "--outage-db")
    ap.add_argument("--rician-k", type=float, default=3.0,
                    help="K-factor for --channel rician")
    ap.add_argument("--ar1-rho", type=float, default=0.9,
                    help="lag-1 temporal correlation for --channel ar1")
    ap.add_argument("--doppler-hz", type=float, default=None,
                    help="maximum Doppler shift f_D (Hz) for --channel "
                         "ar1: rho from Jakes' J0(2*pi*f_D*tau) instead of "
                         "--ar1-rho")
    ap.add_argument("--round-s", type=float, default=1e-3,
                    help="round duration tau (s) in the Jakes mapping of "
                         "--doppler-hz")
    ap.add_argument("--csi-phase-err", type=float, default=0.0,
                    help="residual CSI phase-error std (radians); >0 wraps "
                         "the channel in ImperfectCSI")
    ap.add_argument("--outage-db", type=float, default=None,
                    help="deep-fade outage threshold (dB); set to wrap the "
                         "channel in OutageModel (straggling clients)")
    ap.add_argument("--cell-radius", type=float, default=0.0,
                    help="cell radius (m); >0 wraps the channel in "
                         "PathLossGeometry (per-client mean powers)")
    ap.add_argument("--shadow-std-db", type=float, default=0.0,
                    help="correlated log-normal shadowing std (dB) on the "
                         "PathLossGeometry gains; requires --cell-radius")
    ap.add_argument("--shadow-corr", type=float, default=0.5,
                    help="inter-client shadowing correlation in [0, 1] for "
                         "--shadow-std-db")
    ap.add_argument("--engine", default="loop", choices=["loop", "scan"])
    ap.add_argument("--chunk-rounds", type=int, default=32,
                    help="rounds per chunk under --engine scan (one "
                         "captured CUDA graph replayed per round)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="prepare each chunk inline instead of on the "
                         "prefetch thread")
    ap.add_argument("--rounds", type=int, default=800)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8,
                    help="per-client batch size")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--gamma", type=float, default=5.0)
    ap.add_argument("--n-perturb", type=int, default=4)
    ap.add_argument("--epsilon", type=float, default=5.0)
    ap.add_argument("--delta", type=float, default=0.01)
    ap.add_argument("--power", type=float, default=100.0)
    ap.add_argument("--n0", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=100,
                    help="greedy eval every N rounds (0 = off)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save checkpoints here and resume from the newest "
                         "valid one")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--dropout-p", type=float, default=0.0,
                    help="per-round client dropout probability")
    ap.add_argument("--straggler-p", type=float, default=0.0)
    ap.add_argument("--elastic", default=None,
                    help="membership events: 'round:K,round:K' e.g. "
                         "'200:3,400:5'")
    ap.add_argument("--byzantine", default="none",
                    help="active-adversary client behavior from the "
                         f"byzantine registry {byz.available_behaviors()}; "
                         "'none' (default) runs the honest cohort")
    ap.add_argument("--byzantine-frac", type=float, default=0.25,
                    help="fraction of clients running --byzantine (0 "
                         "disables the attack)")
    ap.add_argument("--byzantine-scale", type=float, default=3.0,
                    help="lambda for scaled_poison, the noise std for "
                         "gaussian_noise")
    ap.add_argument("--defense", default="none",
                    help="server/PHY-side countermeasure from the byzantine "
                         f"registry {byz.available_defenses()}")
    ap.add_argument("--defense-groups", type=int, default=4,
                    help="orthogonal decode sub-slots for robust_decode/"
                         "reweight")
    ap.add_argument("--defense-clip-factor", type=float, default=0.5,
                    help="transmit-clip bound for --defense clip: gamma_d = "
                         "factor * gamma")
    ap.add_argument("--desync-frac", type=float, default=0.0,
                    help="per-round probability a client is a stale "
                         "straggler riding a lagged round seed (0: off)")
    ap.add_argument("--desync-max-lag", type=int, default=4,
                    help="max staleness (rounds) for --desync-frac")
    ap.add_argument("--desync-phase-std", type=float, default=0.0,
                    help="timing/phase-error std (radians): each client's "
                         "OTA contribution is attenuated by cos(theta)")
    ap.add_argument("--desync-frame-symbols", type=int, default=1,
                    help="symbols per frame of the conventional "
                         "d-dimensional baseline (--transport fo only)")
    ap.add_argument("--inject", action="append", default=[],
                    metavar="SITE:MODE[:SEL]",
                    help="arm a deterministic host fault (repeatable): "
                         "site in {chunk_prep, dispatch, ckpt_snapshot, "
                         "ckpt_write}, mode in {exception, delay, "
                         "torn_write}, selector '@2,5' (exact invocation "
                         "indices) or a probability like '0.1' (default: "
                         "every invocation); the recoveries are reported "
                         "under retry_attempts")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for probabilistic --inject selectors")
    ap.add_argument("--audit", action="store_true",
                    help="eavesdropper capture + the seed-replay attack and, "
                         "for DP transports, the Clopper-Pearson eps_hat "
                         "audit against the analytic accountant (exit 1 if "
                         "eps_hat exceeds it)")
    ap.add_argument("--audit-trials", type=int, default=1500,
                    help="paired canary traces for the eps_hat audit")
    ap.add_argument("--trace-out", default=None,
                    help="write the host-side span timeline here as Chrome "
                         "trace-event JSON (Perfetto / chrome://tracing): "
                         "chunk prep, prefetch, stalls, dispatch, metric "
                         "flushes, checkpoint snapshots, plus the run's "
                         "build/capture and stall counters and the first "
                         "round's cost under otherData")
    ap.add_argument("--metrics-out", default=None,
                    help="stream the per-round trilemma ledger here as "
                         "JSONL (schema trilemma_ledger/v2): loss, uplink "
                         "bits, cumulative (eps, delta) spend and the peak "
                         "device-memory watermark, one record a round")
    ap.add_argument("--obs-sample-every", type=int, default=32,
                    help="device-memory sampling period (rounds) for the "
                         "watermark; samples are taken at chunk "
                         "boundaries, so the cadence never changes chunks")
    ap.add_argument("--profile-out", default=None,
                    help="capture the run under torch.profiler and write a "
                         "MERGED Chrome trace here: the aten ops and (on "
                         "the card) the CUDA kernels, aligned onto the host "
                         "span timeline by a perf_counter anchor")
    ap.add_argument("--health-policy", default="off",
                    choices=["off", "warn", "abort"],
                    help="run-health monitor (NaN/Inf, loss divergence, "
                         "plateau) over the per-round losses: 'warn' "
                         "records events in the summary; 'abort' "
                         "checkpoints the last boundary, stops the run and "
                         "exits with status 3; the accountant keeps only "
                         "the realized spend, which --audit consumes")
    ap.add_argument("--health-divergence", type=float, default=10.0,
                    help="divergence factor: fire when the loss exceeds "
                         "this multiple of the running best (<=0 disables "
                         "the detector)")
    ap.add_argument("--health-plateau", type=int, default=0,
                    help="rounds with no new best loss before the plateau "
                         "detector fires; 0 disables it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None, help="write result JSON here")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mechanism = args.transport or args.variant
    byzcfg = None
    if args.byzantine != "none" or args.defense != "none":
        byzcfg = ByzantineConfig(
            behavior=args.byzantine, fraction=args.byzantine_frac,
            scale=args.byzantine_scale, defense=args.defense,
            groups=args.defense_groups,
            clip_factor=args.defense_clip_factor, seed=args.seed)
    desynccfg = None
    if args.desync_frac or args.desync_phase_std:
        desynccfg = DesyncConfig(
            fraction=args.desync_frac, max_lag=args.desync_max_lag,
            phase_std=args.desync_phase_std,
            frame_symbols=args.desync_frame_symbols, seed=args.seed)
    pz = PairZeroConfig(
        variant=args.variant, n_clients=args.clients, rounds=args.rounds,
        zo=ZOConfig(mu=args.mu, lr=args.lr, clip_gamma=args.gamma,
                    n_perturb=args.n_perturb),
        channel=ChannelConfig(n0=args.n0, power=args.power,
                              d=cfg.param_count(), model=args.channel,
                              rician_k=args.rician_k, ar1_rho=args.ar1_rho,
                              doppler_hz=args.doppler_hz,
                              round_duration_s=args.round_s,
                              phase_err_std=args.csi_phase_err,
                              outage_db=args.outage_db,
                              cell_radius=args.cell_radius,
                              shadow_std_db=args.shadow_std_db,
                              shadow_corr=args.shadow_corr),
        dp=DPConfig(epsilon=args.epsilon, delta=args.delta),
        power=PowerControlConfig(scheme=args.scheme),
        transport=TransportConfig(mechanism=mechanism, scheme=args.scheme,
                                  quant_bits=args.quant_bits),
        byzantine=byzcfg, desync=desynccfg, seed=args.seed)
    pipe = FederatedPipeline(
        task=args.task, spec=TaskSpec(args.task, cfg.vocab_size, args.seq_len),
        n_clients=args.clients, per_client_batch=args.batch, seed=args.seed,
        frontend_tokens=cfg.frontend.n_frontend_tokens, d_model=cfg.d_model)

    fault = None
    if args.dropout_p or args.straggler_p:
        fault = FaultModel(args.clients, dropout_p=args.dropout_p,
                           straggler_p=args.straggler_p, seed=args.seed)
    elastic = None
    if args.elastic:
        events = tuple(tuple(int(v) for v in e.split(":"))
                       for e in args.elastic.split(","))
        elastic = ElasticSchedule(args.clients, events=events)

    def log(t, metrics):
        if t % 50 == 0:
            print(f"round {t:5d} loss {metrics['loss']:.4f}", flush=True)

    adversary, attack_hook, hooks = None, None, []
    if args.audit:
        from repro_torch import privacy as pv
        adversary = pv.Adversary()
        # FO's observation is a whole [d] gradient a round: keep 8 rounds
        attack_hook = pv.AttackHook(max_rounds=8 if mechanism == "fo"
                                    else None)
        hooks = [attack_hook]

    # observability: span timeline, memory watermark, the trilemma ledger,
    # the profiler merge and the health monitor, all of which only observe
    telemetry, profiler, health = None, None, None
    if args.trace_out or args.metrics_out or args.profile_out:
        telemetry = obs.Telemetry.on(
            memory_sample_every=args.obs_sample_every,
            cost=bool(args.trace_out or args.profile_out))
        if args.metrics_out:
            hooks = hooks + [obs.MetricsSink(args.metrics_out)]
    if args.health_policy != "off":
        health = obs.HealthMonitor(args.health_policy,
                                   divergence_factor=args.health_divergence,
                                   plateau_rounds=args.health_plateau)
        hooks = hooks + [health]
    injector = FaultInjector.from_specs(
        args.inject, seed=args.inject_seed,
        tracer=telemetry.tracer if telemetry is not None
        else obs.NULL_TRACER) if args.inject else None
    if args.profile_out:
        profiler = obs.ProfilerSession()
        profiler.start()

    res = fedsim.run(cfg, pz, pipe, rounds=args.rounds, engine=args.engine,
                     chunk_rounds=args.chunk_rounds,
                     eval_every=args.eval_every,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     fault=fault, elastic=elastic, injector=injector,
                     on_round=log, overlap=not args.no_overlap,
                     adversary=adversary, hooks=hooks, telemetry=telemetry,
                     device=args.device)
    if profiler is not None:
        profiler.stop()
    if args.trace_out or args.profile_out:
        metadata = {
            "engine": args.engine,
            "overlap": not args.no_overlap,
            "prep_stall_s": res.prep_stall_s,
            "ckpt_stall_s": res.ckpt_stall_s,
            "peak_bytes": res.peak_bytes,
            "compile_stats": res.compile_stats,
        }
        if res.cost_stats is not None:
            metadata["cost_stats"] = res.cost_stats
        if args.trace_out:
            telemetry.tracer.export_chrome(args.trace_out, metadata=metadata)
            print(f"trace timeline -> {args.trace_out}", flush=True)
        if args.profile_out:
            device_events, profile_meta = profiler.device_events(
                telemetry.tracer.epoch)
            telemetry.tracer.export_chrome(
                args.profile_out,
                metadata={**metadata, "profile": profile_meta},
                extra_events=device_events)
            print(f"merged device+host timeline -> {args.profile_out} "
                  f"({profile_meta['events']} profiler events, "
                  f"{profile_meta['kernels']} kernels)", flush=True)
    audit_summary = None
    if args.audit:
        audit_summary = run_audit(pz, res, attack_hook, args)
    summary = {
        "arch": cfg.name, "transport": mechanism, "scheme": args.scheme,
        "channel": args.channel or "rayleigh", "engine": args.engine,
        "device": args.device,
        "byzantine": ({"behavior": args.byzantine,
                       "fraction": args.byzantine_frac,
                       "defense": args.defense}
                      if byzcfg is not None else None),
        "desync": ({"fraction": args.desync_frac,
                    "max_lag": args.desync_max_lag,
                    "phase_std": args.desync_phase_std}
                   if desynccfg is not None else None),
        "retry_attempts": res.retry_attempts,
        "injected": injector.fired if injector is not None else {},
        "rounds": res.steps,
        "uplink_bits": res.uplink_bits,
        "final_loss": res.losses[-1] if res.losses else None,
        "privacy_spent": res.privacy_spent,
        "privacy_budget": res.privacy_budget,
        "accuracies": res.accuracies,
        "prep_stall_s": round(res.prep_stall_s, 3),
        "ckpt_stall_s": round(res.ckpt_stall_s, 3),
        "wall_time_s": round(res.wall_time_s, 1),
        "peak_bytes": res.peak_bytes,
        "compile_stats": res.compile_stats,
        "resumed_from": res.resumed_from,
    }
    if res.cost_stats is not None:
        summary["cost_stats"] = res.cost_stats
    if health is not None:
        summary["health"] = {
            "policy": args.health_policy,
            "events": health.events,
            "abort_round": res.health_abort_round,
            "abort_reason": res.health_abort_reason,
        }
    if audit_summary is not None:
        summary["audit"] = audit_summary
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "losses": res.losses}, f)
    if audit_summary is not None and not audit_summary.get("dominated", True):
        raise SystemExit("AUDIT FAILURE: empirical eps_hat "
                         f"{audit_summary['eps_hat']:.4f} exceeds the "
                         "analytic accountant's "
                         f"{audit_summary['eps_analytic']:.4f}")
    if res.health_abort_round >= 0:
        # a status of its own: a health abort (3), not an audit failure (1)
        print(f"HEALTH ABORT: {res.health_abort_reason} at round "
              f"{res.health_abort_round}; the accountant charged only the "
              f"{res.steps} executed rounds", flush=True)
        raise SystemExit(3)
    return summary


def run_audit(pz, res, attack_hook, args) -> dict:
    """The post-run privacy audit: seed replay on the captured
    observations, and on DP transports the paired-trace ε̂ (on
    `args.device`) against the run's own accountant ledger. An active
    defense adjusts the audited config (a transmit clip shrinks the
    canary to γ_d)."""
    from repro_torch import privacy as pv
    defense = byz.resolve_defense(pz)
    if defense is not None:
        pz = defense.audited_pz(pz)
    out: dict = {}
    obs = attack_hook.observations()
    payloads = attack_hook.payloads()
    if payloads is not None and ("obs_y" in obs or "obs_q" in obs):
        # scored against what was radiated (±1 ballots for sign)
        payloads = np.asarray(res.transport.transmitted(payloads))
        replay = pv.get("seed_replay")().run(
            obs, payloads, res.schedule.c, attack_hook.k_eff())
        out["seed_replay"] = {
            "victim_rmse": replay["victim_rmse"],
            "mean_rmse": replay["mean_rmse"],
            "per_client_exposed": replay["per_client_exposed"],
        }
    if res.transport.canary_payload(pz) is not None:
        audit = pv.audit_transport(
            res.transport, res.schedule, pz,
            rounds=max(res.steps, 1), trials=args.audit_trials,
            spent=res.privacy_spent, device=args.device)
        out.update(audit.to_dict())
        verdict = "OK (eps_hat <= analytic)" if audit.dominated \
            else "VIOLATED"
        print(f"privacy audit: eps_hat={audit.eps_hat:.4f} <= "
              f"analytic eps={audit.eps_analytic:.4f}? {verdict}",
              flush=True)
    else:
        out["auditable"] = False
        print(f"privacy audit: transport {res.transport.name!r} provides "
              "no DP guarantee (payloads individually exposed; see "
              "seed_replay metrics)", flush=True)
    return out


if __name__ == "__main__":
    main()
