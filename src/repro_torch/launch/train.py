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
fault injection (--inject site:mode[:selector], --inject-seed), plus
--device. Prints the reference's JSON summary keys that the port fills.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import (ChannelConfig, DPConfig, PairZeroConfig,
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
        seed=args.seed)
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
    injector = FaultInjector.from_specs(args.inject, seed=args.inject_seed) \
        if args.inject else None

    def log(t, metrics):
        if t % 50 == 0:
            print(f"round {t:5d} loss {metrics['loss']:.4f}", flush=True)

    res = fedsim.run(cfg, pz, pipe, rounds=args.rounds, engine=args.engine,
                     chunk_rounds=args.chunk_rounds,
                     eval_every=args.eval_every,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     fault=fault, elastic=elastic, injector=injector,
                     on_round=log, overlap=not args.no_overlap,
                     device=args.device)
    summary = {
        "arch": cfg.name, "transport": mechanism, "scheme": args.scheme,
        "channel": args.channel or "rayleigh", "engine": args.engine,
        "device": args.device,
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
        "resumed_from": res.resumed_from,
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "losses": res.losses}, f)
    return summary


if __name__ == "__main__":
    main()
