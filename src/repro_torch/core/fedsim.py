"""Federated simulation driver (Algorithm 1 end to end), ported from
`repro.core.fedsim` for the loop engine.

`Experiment` is the host-side orchestrator: it realizes the channel for the
horizon, asks the Transport for its schedule (Theorem-3 power control),
then walks the rounds one at a time through the loop executor, charging the
DP accountant before each round (hard stop on overspend) and firing the
round hooks. Options of the reference that this port does not carry yet
raise NotImplementedError naming their ROADMAP item; none is ignored.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import channel, resolve_device
from repro_torch.configs.base import ModelConfig, PairZeroConfig
from repro_torch.core import engine as eng
from repro_torch.core import pairzero
from repro_torch.core import transport as tp
from repro_torch.core.dp import PrivacyAccountant, cumulative_spend
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.models import registry

# reference options not ported yet → the ROADMAP item that ports them
_UNPORTED = {
    "chunk_rounds": "A5: scan executor",
    "overlap": "A5: scan executor",
    "eval_n": "A5: eval hook",
    "checkpoint_every": "A6: checkpoints",
    "channel_model": "A2: other channel models and wrappers",
    "fault": "A7: faults and elastic membership",
    "elastic": "A7: faults and elastic membership",
    "adversary": "A9: privacy subsystem",
    "behavior": "A9: byzantine subsystem",
    "defense": "A9: byzantine subsystem",
    "telemetry": "A9: observability",
    "desync": "A9: desync",
    "injector": "A9: fault injection",
    "mesh": "A11: mesh engine",
}


def _reject(option: str, value: Any) -> None:
    if value is not None and value is not False and value != 0:
        raise NotImplementedError(
            f"{option}={value!r} is not ported (ROADMAP {_UNPORTED[option]})")


@dataclass
class RunResult:
    losses: List[float] = field(default_factory=list)
    p_hats: List[float] = field(default_factory=list)
    privacy_spent: float = 0.0
    privacy_budget: float = 0.0
    steps: int = 0
    wall_time_s: float = 0.0
    privacy_exhausted_at: int = -1   # round at which the guard tripped
    uplink_bits: int = 0             # total uplink spend (Transport-accounted)
    params: Optional[Any] = None     # final model parameters
    schedule: Optional[Any] = None   # the base station's offline solve
    transport: Optional[Any] = None
    # [steps] cumulative Eq.-16 ledger after each executed round
    privacy_spent_per_round: Optional[np.ndarray] = None


class RoundHook:
    """Host-side side effect wired into the driver loop (the reference's
    start/boundary/close callbacks serve its eval and checkpoint hooks,
    which are not ported)."""

    def on_round(self, t: int, metrics: Dict[str, np.ndarray]) -> None:
        """Per executed round, with that round's host-side metrics."""


class CallbackHook(RoundHook):
    """Per-round logging callback (the `on_round=` kwarg)."""

    def __init__(self, fn: Callable[[int, Dict], None]):
        self._fn = fn

    def on_round(self, t: int, metrics: Dict[str, np.ndarray]) -> None:
        self._fn(t, metrics)


class Experiment:
    """One federated run: model + pAirZero config + data + a Transport.

    The tensors passed as `params` are updated in place by the chained walk
    (the run owns them; pass a copy to keep the originals). Without
    `params`, the run initializes random weights from `pz.seed`."""

    def __init__(self, model_cfg: ModelConfig, pz: PairZeroConfig,
                 pipeline: FederatedPipeline, rounds: int, *,
                 engine: str = "loop",
                 transport: Optional[tp.Transport] = None,
                 hooks: Sequence[RoundHook] = (),
                 params: Optional[Dict] = None, device="cuda"):
        if engine != "loop":
            raise NotImplementedError(
                f"engine={engine!r} is not ported (ROADMAP A5: scan "
                "executor); only 'loop'")
        for name, item in (("byzantine", "A9: byzantine subsystem"),
                           ("desync", "A9: desync")):
            if getattr(pz, name) is not None:
                raise NotImplementedError(
                    f"pz.{name} is not ported (ROADMAP {item})")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.pz = pz
        self.pipeline = pipeline
        self.rounds = rounds
        self.transport = transport if transport is not None \
            else tp.resolve(pz)
        self.channel_model = channel.from_config(pz.channel)
        self.step = pairzero.make_zo_step(model_cfg, pz, self.transport)
        self.hooks = list(hooks)
        self.params = params
        self.result = RunResult()
        self.accountant = PrivacyAccountant(pz.dp.epsilon, pz.dp.delta)

    def run(self) -> RunResult:
        t0 = time.time()
        pz, result, dev = self.pz, self.result, self.device
        result.privacy_budget = self.accountant.budget
        # channel + schedule over the PLANNED horizon (Theorem 3 budgets
        # privacy across all T), exactly as the reference realizes them
        horizon = max(pz.rounds, self.rounds)
        ctrace = self.channel_model.realize(pz.seed ^ 0xC4A7, horizon,
                                            pz.n_clients)
        schedule = self.transport.make_schedule(ctrace, pz)
        result.schedule, result.transport = schedule, self.transport
        if self.params is None:
            gen = torch.Generator(device=dev).manual_seed(pz.seed)
            self.params = registry.init_params(self.model_cfg, gen, dev)

        executor = eng.LoopExecutor(self.step)
        client_rounds = 0.0
        # one-round spans: the loop engine dispatches and syncs per round
        for a, b in eng.chunk_boundaries(0, self.rounds, 1):
            trace = eng.build_trace(schedule, pz, a, b, device=dev,
                                    transport=self.transport)
            n_ok = eng.affordable_rounds(self.accountant, trace)
            if n_ok == 0:
                result.privacy_exhausted_at = a
                break
            eng.charge_rounds(self.accountant, trace, n_ok)
            client_rounds += float(trace.host_masks[:n_ok].sum())
            batches = eng.stack_batches(self.pipeline, a, a + n_ok, dev)
            self.params, metrics = executor.run(self.params, trace.rows(n_ok),
                                                batches)
            host = {k: v.cpu().numpy() for k, v in metrics.items()}
            result.losses.extend(float(x) for x in host["loss"])
            result.p_hats.extend(float(x) for x in host["p_hat"])
            for hook in self.hooks:
                for r in range(n_ok):
                    hook.on_round(a + r, {k: v[r] for k, v in host.items()})
            if n_ok < b - a:              # guard tripped mid-span: hard stop
                result.privacy_exhausted_at = a + n_ok
                break

        result.steps = len(result.losses)
        result.privacy_spent = self.accountant.spent
        costs = np.asarray(self.accountant.history, dtype=np.float64)
        if costs.size != result.steps:
            costs = np.zeros(result.steps, dtype=np.float64)
        result.privacy_spent_per_round = cumulative_spend(costs)
        result.uplink_bits = int(round(
            self.transport.payload_bits(pz, self.model_cfg.param_count())
            * client_rounds))
        result.wall_time_s = time.time() - t0
        result.params = self.params
        return result


def run(model_cfg: ModelConfig, pz: PairZeroConfig,
        pipeline: FederatedPipeline, rounds: int, *,
        engine: str = "loop", eval_every: int = 0,
        checkpoint_dir: Optional[str] = None,
        params: Optional[Dict] = None,
        on_round: Optional[Callable[[int, Dict], None]] = None,
        transport: Optional[tp.Transport] = None,
        hooks: Sequence[RoundHook] = (), device="cuda",
        **unported) -> RunResult:
    """Run `rounds` rounds of pAirZero on one device (default: the GPU).

    Mirrors `repro.core.fedsim.run` for the loop engine. `device="cpu"`
    runs the plain PyTorch versions of the kernels (the tests' path);
    "cuda" raises when no GPU is present."""
    if eval_every:
        raise NotImplementedError("eval_every is not ported (ROADMAP A5: "
                                  "eval hook)")
    if checkpoint_dir:
        raise NotImplementedError("checkpoint_dir is not ported (ROADMAP "
                                  "A6: checkpoints)")
    for option, value in unported.items():
        if option not in _UNPORTED:
            raise TypeError(f"run() got an unexpected keyword argument "
                            f"{option!r}")
        _reject(option, value)
    all_hooks: List[RoundHook] = list(hooks)
    if on_round is not None:
        all_hooks.append(CallbackHook(on_round))
    return Experiment(model_cfg, pz, pipeline, rounds, engine=engine,
                      transport=transport, hooks=all_hooks, params=params,
                      device=device).run()
