"""End to end: federated DP fine-tuning with faults and checkpoints, ported
from the reference's `examples/federated_finetune.py`.

    # fast preset (a 2-layer model):
    PYTHONPATH=src python -m repro_torch.examples.federated_finetune

    # the paper's own model, OPT-125M, on the GPU:
    PYTHONPATH=src python -m repro_torch.examples.federated_finetune \\
        --preset opt125m --rounds 300

Theorem-3 power control under Rayleigh block fading, the (ε, δ) privacy
accountant, client dropout and stragglers, elastic membership (client 4
leaves at 60% of the run and returns at 80%), crash-safe checkpoints
every third of the run, and resume: re-running the same command continues
from the newest valid checkpoint in --ckpt.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import (ChannelConfig, DPConfig, ModelConfig,
                                      PairZeroConfig, TransportConfig,
                                      ZOConfig)
from repro_torch.core import fedsim
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.data.tasks import TaskSpec
from repro_torch.runtime.fault import ElasticSchedule, FaultModel

PRESETS = {
    "tiny": dict(arch=None, rounds=600, lr=2e-3, seq=24, batch=8),
    "small": dict(arch=None, rounds=400, lr=5e-3, seq=32, batch=8),
    "opt125m": dict(arch="opt-125m", rounds=300, lr=5e-7, seq=64, batch=4),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--transport", default="analog",
                    choices=["analog", "sign", "digital"],
                    help="uplink mechanism; 'digital' is the conventional "
                         "quantized baseline")
    ap.add_argument("--epsilon", type=float, default=None,
                    help="DP ε (default: 50 for the fast presets, whose "
                         "short horizons would otherwise stay in the noise "
                         "floor; 5 for opt125m)")
    ap.add_argument("--engine", default="loop", choices=["loop", "scan"])
    ap.add_argument("--chunk-rounds", type=int, default=16)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "pairzero_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> fedsim.RunResult:
    args = build_parser().parse_args(argv)
    p = PRESETS[args.preset]
    rounds = args.rounds or p["rounds"]

    if p["arch"]:
        model = get_arch(p["arch"])
        gamma = 100.0               # the paper's γ for OPT-125M
    else:
        width = 64 if args.preset == "tiny" else 128
        model = ModelConfig(name=f"{args.preset}-lm", family="dense",
                            n_layers=2 if args.preset == "tiny" else 4,
                            d_model=width, n_heads=4, n_kv_heads=2,
                            d_ff=2 * width, vocab_size=64, head_dim=16)
        gamma = 5.0

    eps = args.epsilon if args.epsilon is not None else (
        5.0 if args.preset == "opt125m" else 50.0)
    pz = PairZeroConfig(
        n_clients=5, rounds=rounds,
        zo=ZOConfig(mu=1e-3, lr=p["lr"], clip_gamma=gamma, n_perturb=4),
        channel=ChannelConfig(n0=1.0, power=100.0, d=model.param_count()),
        # the digital baseline has no DP mechanism: run it non-private
        dp=DPConfig(epsilon=eps, delta=0.01,
                    enabled=args.transport != "digital"),
        transport=TransportConfig(mechanism=args.transport,
                                  scheme="solution"))
    data = FederatedPipeline(task="sst2",
                             spec=TaskSpec("sst2", model.vocab_size,
                                           p["seq"]),
                             n_clients=5, per_client_batch=p["batch"],
                             seed=0)

    fault = FaultModel(n_clients=5, dropout_p=0.05, straggler_p=0.02,
                       seed=1)
    elastic = ElasticSchedule(n_clients=5, events=(
        (int(rounds * 0.6), 4), (int(rounds * 0.8), 5)))

    print(f"== federated fine-tune: {model.name} "
          f"({model.param_count() / 1e6:.1f}M params), {args.transport}, "
          f"Theorem-3 power control, ε={eps:g}, {rounds} rounds ==")
    res = fedsim.run(
        model, pz, data, rounds=rounds,
        engine=args.engine, chunk_rounds=args.chunk_rounds,
        eval_every=max(rounds // 4, 1), eval_n=256,
        checkpoint_dir=args.ckpt, checkpoint_every=max(rounds // 3, 1),
        fault=fault, elastic=elastic, device=args.device,
        on_round=lambda t, m: t % max(rounds // 10, 1) == 0 and print(
            f"  round {t:5d}  loss {float(m['loss']):.4f}  K_eff "
            f"{int(m.get('k_eff', 5))}"))

    if res.losses:
        print(f"\nfinal loss     : {np.mean(res.losses[-10:]):.4f} "
              f"(start {np.mean(res.losses[:5]):.4f})")
    else:
        print(f"\nno round left  : resumed at round {res.resumed_from} of "
              f"{rounds}")
    if res.accuracies:
        print(f"accuracies     : {[round(a, 2) for a in res.accuracies]}")
    if args.transport == "digital":
        print("privacy        : NONE — digital orthogonal uplink exposes "
              "each client's payload (the trilemma's third corner)")
    else:
        print(f"privacy        : spent {res.privacy_spent:.4f} of "
              f"{res.privacy_budget:.4f}  (ε={eps:g}, δ=0.01)")
    print(f"uplink         : {res.uplink_bits / 8e6:.3f} MB total over "
          f"{res.steps} rounds ({args.transport} transport)")
    print(f"checkpoints in : {args.ckpt} (re-run to resume from "
          f"round {res.steps + res.resumed_from})")
    return res


if __name__ == "__main__":
    main()
