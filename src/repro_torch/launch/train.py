"""Training launcher: federated pAirZero fine-tuning on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
        --arch opt-125m --rounds 800 --clients 5 --engine scan

The main-path subset of `repro.launch.train`'s flags (analog transport,
`solution` schedule, Rayleigh channel, sst2, the loop and scan engines,
the eval hook), plus --device. Prints the reference's JSON summary keys
that the port fills.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import (ChannelConfig, DPConfig, PairZeroConfig,
                                      PowerControlConfig, TransportConfig,
                                      ZOConfig)
from repro_torch.core import fedsim
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.data.tasks import TaskSpec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="opt-125m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--task", default="sst2", choices=["sst2"])
    ap.add_argument("--transport", default="analog", choices=["analog"])
    ap.add_argument("--scheme", default="solution", choices=["solution"])
    ap.add_argument("--channel", default="rayleigh", choices=["rayleigh"])
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None, help="write result JSON here")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pz = PairZeroConfig(
        variant=args.transport, n_clients=args.clients, rounds=args.rounds,
        zo=ZOConfig(mu=args.mu, lr=args.lr, clip_gamma=args.gamma,
                    n_perturb=args.n_perturb),
        channel=ChannelConfig(n0=args.n0, power=args.power,
                              d=cfg.param_count(), model=args.channel),
        dp=DPConfig(epsilon=args.epsilon, delta=args.delta),
        power=PowerControlConfig(scheme=args.scheme),
        transport=TransportConfig(mechanism=args.transport,
                                  scheme=args.scheme),
        seed=args.seed)
    pipe = FederatedPipeline(
        task=args.task, spec=TaskSpec(args.task, cfg.vocab_size, args.seq_len),
        n_clients=args.clients, per_client_batch=args.batch, seed=args.seed)

    def log(t, metrics):
        if t % 50 == 0:
            print(f"round {t:5d} loss {metrics['loss']:.4f}", flush=True)

    res = fedsim.run(cfg, pz, pipe, rounds=args.rounds, engine=args.engine,
                     chunk_rounds=args.chunk_rounds,
                     eval_every=args.eval_every, on_round=log,
                     overlap=not args.no_overlap, device=args.device)
    summary = {
        "arch": cfg.name, "transport": args.transport, "scheme": args.scheme,
        "channel": args.channel, "engine": args.engine,
        "device": args.device,
        "rounds": res.steps,
        "uplink_bits": res.uplink_bits,
        "final_loss": res.losses[-1] if res.losses else None,
        "privacy_spent": res.privacy_spent,
        "privacy_budget": res.privacy_budget,
        "accuracies": res.accuracies,
        "prep_stall_s": round(res.prep_stall_s, 3),
        "wall_time_s": round(res.wall_time_s, 1),
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "losses": res.losses}, f)
    return summary


if __name__ == "__main__":
    main()
