"""Federated simulation driver (Algorithm 1 end to end), ported from
`repro.core.fedsim`.

`Experiment` is the host-side orchestrator: it realizes the channel for the
horizon (`channel_model`, or the stack `pz.channel` configures), asks the
Transport for its schedule (Theorem-3/4 power control), then walks the
rounds in chunks through an executor (`engine="loop"`: one round a chunk,
dispatched round by round; `engine="scan"`: up to
`chunk_rounds` rounds a chunk, replayed from one captured CUDA graph on the
card), charging the DP accountant before each chunk (hard stop on
overspend, truncating the chunk before dispatch) and firing the round
hooks. Both engines run this same loop; chunk boundaries are aligned to the
hook cadences, chunk i+1 is prepared on a worker thread while chunk i runs
(`overlap`), and under scan a chunk's metrics reach the host one chunk late.
The `fo` transport swaps the round for the first-order baseline's (FO-Adam,
its state carried beside the params); it charges no privacy.
Options of the reference that this port does not carry yet raise
NotImplementedError naming their ROADMAP item; none is ignored.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import channel, prng, resolve_device
from repro_torch.configs.base import ModelConfig, PairZeroConfig
from repro_torch.core import engine as eng
from repro_torch.core import pairzero
from repro_torch.core import transport as tp
from repro_torch.core.dp import PrivacyAccountant, cumulative_spend
from repro_torch.data import tasks as T
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.optim import fo as fo_opt

# reference options not ported yet → the ROADMAP item that ports them
_UNPORTED = {
    "checkpoint_every": "A6: checkpoints",
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
    opt_state: Optional[Any] = None  # FO: the optimizer's final state
    schedule: Optional[Any] = None   # the base station's offline solve
    transport: Optional[Any] = None
    # [steps] cumulative Eq.-16 ledger after each executed round
    privacy_spent_per_round: Optional[np.ndarray] = None
    accuracies: List[float] = field(default_factory=list)
    prep_stall_s: float = 0.0        # driver blocked on host-side chunk prep


class RoundHook:
    """Host-side side effect wired into the driver loop.

    `cadence` (rounds) aligns chunk boundaries so `on_boundary` fires at
    exactly the multiples it would under per-round dispatch. `on_round`
    receives every round's host metrics (one chunk late under the scan
    engine, never reordered)."""
    cadence: int = 0

    def on_start(self, exp: "Experiment") -> None:
        """Before round execution."""

    def on_round(self, t: int, metrics: Dict[str, np.ndarray]) -> None:
        """Per executed round, with that round's host-side metrics."""

    def on_boundary(self, t_done: int, exp: "Experiment") -> None:
        """At every aligned chunk boundary (t_done rounds executed)."""

    def close(self, exp: "Experiment") -> None:
        """After the run."""


def eval_logits(params: Dict, model_cfg: ModelConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """The greedy eval's logits at the last position, [n, V] f32: the
    model's forward, then the lm head (or the tied embedding) on x[:, -1]
    only. `tasks.accuracy` reads no other position, and for
    recurrentgemma-2b the full [64, 64, 256000] logits would take 4.2 GB."""
    x = registry.get_module(model_cfg).forward(params, model_cfg, tokens)
    head = params.get("lm_head", params["embed"])
    return L.unembed(head, x[:, -1])


class EvalHook(RoundHook):
    """Greedy eval on the held-out batch every `cadence` rounds, appending
    to `RunResult.accuracies`."""

    def __init__(self, every: int, eval_n: int = 64):
        self.cadence = every
        self.eval_n = eval_n

    def on_boundary(self, t_done: int, exp: "Experiment") -> None:
        if self.cadence and t_done % self.cadence == 0:
            ebatch = exp.pipeline.eval_batch(self.eval_n)
            tokens = torch.from_numpy(ebatch["tokens"].astype(np.int64))
            logits = eval_logits(exp.params, exp.model_cfg,
                                 tokens.to(exp.device))
            # [n, 1, V]: the answer position is the only one scored
            host = logits[:, None, :].cpu().numpy()
            exp.result.accuracies.append(T.accuracy(host, ebatch))


class CallbackHook(RoundHook):
    """Per-round logging callback (the `on_round=` kwarg)."""

    def __init__(self, fn: Callable[[int, Dict], None]):
        self._fn = fn

    def on_round(self, t: int, metrics: Dict[str, np.ndarray]) -> None:
        self._fn(t, metrics)


class Experiment:
    """One federated run: model + pAirZero config + data + a Transport.

    The tensors passed as `params` are updated in place (the run owns them;
    pass a copy to keep the originals). Without `params`, the run draws the
    reference's initial weights from `prng.key(pz.seed)`. Under the `fo`
    transport the round is the first-order baseline's
    (`pairzero.make_fo_step`, FO-Adam at `pz.zo.lr`, as the reference
    runs it), its Adam state made at the start of `run`."""

    def __init__(self, model_cfg: ModelConfig, pz: PairZeroConfig,
                 pipeline: FederatedPipeline, rounds: int, *,
                 engine: str = "loop", chunk_rounds: int = 32,
                 transport: Optional[tp.Transport] = None,
                 channel_model: Optional[channel.ChannelModel] = None,
                 hooks: Sequence[RoundHook] = (),
                 params: Optional[Dict] = None, overlap: bool = True,
                 device="cuda"):
        if engine not in ("scan", "loop"):
            raise ValueError(
                f"unknown engine: {engine!r} (want 'scan'|'loop')")
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
        self.engine = engine
        self.chunk_rounds = chunk_rounds
        self.overlap = overlap
        self.transport = transport if transport is not None \
            else tp.resolve(pz)
        # an explicit ChannelModel overrides the pz.channel config stack
        self.channel_model = channel_model if channel_model is not None \
            else channel.from_config(pz.channel)
        if self.transport.kind == "fo":
            # the reference's FO baseline: FO-Adam at the ZO learning rate
            self.optimizer = fo_opt.make("adam", pz.zo.lr)
            self.step = pairzero.make_fo_step(model_cfg, self.optimizer)
        else:
            self.optimizer = None
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
            self.params = registry.init_params(self.model_cfg,
                                               prng.key(pz.seed), dev)
        for hook in self.hooks:
            hook.on_start(self)
        # the step's carry: the params, or under FO (params, Adam's state)
        carry = self.params if self.optimizer is None \
            else (self.params, self.optimizer.init(self.params))

        executor = eng.LoopExecutor(self.step) if self.engine == "loop" \
            else eng.get_executor(self.step)
        align = tuple(hk.cadence for hk in self.hooks if hk.cadence)
        # the loop engine dispatches (and syncs) one round at a time: one-
        # round chunks keep its metrics and on_round live
        span = 1 if self.engine == "loop" else self.chunk_rounds
        bounds = eng.chunk_boundaries(0, self.rounds, span, align)
        n_leaves = len(registry.shapes(self.model_cfg))
        stager = eng.BatchStager(self.pipeline, dev)
        # the worker thread's copies go to the stream the chunks run on
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None

        # the transport's random rows for every round, in one draw
        draws = eng.draw_rows(self.transport, pz, 0, self.rounds)

        def prepare(a: int, b: int):
            with torch.cuda.stream(stream):
                trace = eng.build_trace(schedule, pz, a, b, device=dev,
                                        n_leaves=n_leaves,
                                        transport=self.transport,
                                        channel=ctrace,
                                        draws={k: v[a:b] for k, v in
                                               draws.items()})
                return trace, stager.stage(a, b)

        prefetch = eng.ChunkPrefetcher(prepare, bounds, overlap=self.overlap)
        # software pipelining: chunk i-1's metrics are synced after chunk i
        # has been dispatched, so the sync overlaps the device's work
        pending = None            # (first_round, n_rounds, metrics)
        client_rounds = 0.0

        def flush() -> None:
            nonlocal pending
            if pending is None:
                return
            a0, n_rounds, metrics = pending
            pending = None
            host = {k: v.cpu().numpy() for k, v in metrics.items()}
            result.losses.extend(float(x) for x in host["loss"])
            if "p_hat" in host:                 # FO has no scalar uplink
                result.p_hats.extend(float(x) for x in host["p_hat"])
            for hook in self.hooks:
                for r in range(n_rounds):
                    hook.on_round(a0 + r, {k: v[r] for k, v in host.items()})

        try:
            for i, (a, b) in enumerate(bounds):
                trace, batches = prefetch.get(i)
                n_ok = eng.affordable_rounds(self.accountant, trace)
                if n_ok == 0:
                    result.privacy_exhausted_at = a
                    break
                eng.charge_rounds(self.accountant, trace, n_ok)
                client_rounds += float(trace.host_masks[:n_ok].sum())
                if n_ok < b - a:          # guard trips mid-chunk: truncate
                    batches = {k: v[:n_ok] for k, v in batches.items()}
                carry, metrics = executor.run(carry, trace.rows(n_ok),
                                              batches)
                self.params = carry if self.optimizer is None else carry[0]
                flush()                   # sync chunk i-1 while chunk i runs
                pending = (a, n_ok, metrics)
                if self.engine == "loop":
                    flush()               # per-round dispatch: deliver now
                # chunk i-1 is synced, so its stager slot (shared with
                # chunk i+1) may be rewritten: start the next preparation
                prefetch.kick(i + 1)
                t_done = a + n_ok
                if n_ok < b - a:          # guard tripped mid-chunk: hard stop
                    flush()
                    result.privacy_exhausted_at = t_done
                    break
                for hook in self.hooks:
                    hook.on_boundary(t_done, self)
        finally:
            prefetch.close()
        flush()
        for hook in self.hooks:
            hook.close(self)

        result.steps = len(result.losses)
        result.privacy_spent = self.accountant.spent
        costs = np.asarray(self.accountant.history, dtype=np.float64)
        if costs.size != result.steps:
            costs = np.zeros(result.steps, dtype=np.float64)
        result.privacy_spent_per_round = cumulative_spend(costs)
        result.uplink_bits = tp.uplink_bits_total(
            self.transport, None, pz, self.model_cfg.param_count(),
            client_rounds, result.steps)
        result.prep_stall_s = prefetch.stall_s
        result.wall_time_s = time.time() - t0
        result.params = self.params
        if self.optimizer is not None:
            result.opt_state = carry[1]
        return result


def run(model_cfg: ModelConfig, pz: PairZeroConfig,
        pipeline: FederatedPipeline, rounds: int, *,
        engine: str = "loop", chunk_rounds: int = 32,
        eval_every: int = 0, eval_n: int = 64,
        checkpoint_dir: Optional[str] = None,
        params: Optional[Dict] = None,
        on_round: Optional[Callable[[int, Dict], None]] = None,
        transport: Optional[tp.Transport] = None,
        channel_model: Optional[channel.ChannelModel] = None,
        overlap: bool = True, hooks: Sequence[RoundHook] = (),
        device="cuda", **unported) -> RunResult:
    """Run `rounds` rounds of pAirZero on one device (default: the GPU).

    Mirrors `repro.core.fedsim.run`: `engine="scan"` runs chunks of up to
    `chunk_rounds` rounds (one captured CUDA graph replayed per round on the
    card), `eval_every` adds an `EvalHook` (accuracies on `eval_n` held-out
    sequences), `overlap=False` prepares each chunk inline instead of on
    the prefetch thread. `device="cpu"` runs the plain PyTorch versions of
    the kernels (the tests' path); "cuda" raises when no GPU is present."""
    if checkpoint_dir:
        raise NotImplementedError("checkpoint_dir is not ported (ROADMAP "
                                  "A6: checkpoints)")
    for option, value in unported.items():
        if option not in _UNPORTED:
            raise TypeError(f"run() got an unexpected keyword argument "
                            f"{option!r}")
        _reject(option, value)
    all_hooks: List[RoundHook] = list(hooks)
    if eval_every:
        all_hooks.append(EvalHook(eval_every, eval_n))
    if on_round is not None:
        all_hooks.append(CallbackHook(on_round))
    return Experiment(model_cfg, pz, pipeline, rounds, engine=engine,
                      chunk_rounds=chunk_rounds, transport=transport,
                      channel_model=channel_model, hooks=all_hooks,
                      params=params, overlap=overlap, device=device).run()
