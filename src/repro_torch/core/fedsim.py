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

Client faults and elastic membership (`fault`, `elastic`) mask clients out
of rounds through the control trace. `CheckpointHook` restores the newest
valid checkpoint at the start (params, the DP ledger and the round to
resume from) and saves every `cadence` rounds; a resumed run rebuilds the
channel, the schedule, the masks, the transport's draws and the data from
its start round on. Under FO the checkpoint holds the params only, as the
reference's does, so a resumed FO run starts Adam afresh. `injector` arms
the host fault-injection sites (`runtime.inject`): a dispatch retries only
when its site is armed.

Options of the reference that this port does not carry yet raise
NotImplementedError naming their ROADMAP item; none is ignored.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import channel, prng, resolve_device
from repro_torch.configs.base import ModelConfig, PairZeroConfig
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import engine as eng
from repro_torch.core import pairzero
from repro_torch.core import transport as tp
from repro_torch.core.dp import PrivacyAccountant, cumulative_spend
from repro_torch.data import tasks as T
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.optim import fo as fo_opt
from repro_torch.runtime import inject as inj
from repro_torch.runtime.fault import ElasticSchedule, FaultModel

# reference options not ported yet → the ROADMAP item that ports them
_UNPORTED = {
    "adversary": "A9: privacy subsystem",
    "behavior": "A9: byzantine subsystem",
    "defense": "A9: byzantine subsystem",
    "telemetry": "A9: observability",
    "desync": "A9: desync",
    "mesh": "A11: mesh engine",
}
_IMPL_DTYPE = "A12: kernel implementation and dtype selection"


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
    resumed_from: int = 0            # the round a restored checkpoint held
    prep_stall_s: float = 0.0        # driver blocked on host-side chunk prep
    ckpt_stall_s: float = 0.0        # driver blocked in checkpoint snapshots
    # nonzero retry / degradation counters by site ("dispatch",
    # "ckpt_write", "prefetch_degraded", "ckpt_write_failed",
    # "ckpt_snapshot_failed"); empty on a clean run
    retry_attempts: Dict[str, int] = field(default_factory=dict)


class RoundHook:
    """Host-side side effect wired into the driver loop.

    `cadence` (rounds) aligns chunk boundaries so `on_boundary` fires at
    exactly the multiples it would under per-round dispatch. `on_round`
    receives every round's host metrics (one chunk late under the scan
    engine, never reordered)."""
    cadence: int = 0

    def on_start(self, exp: "Experiment") -> None:
        """Before round execution; may restore state (params, accountant,
        start round)."""

    def on_round(self, t: int, metrics: Dict[str, np.ndarray]) -> None:
        """Per executed round, with that round's host-side metrics."""

    def on_boundary(self, t_done: int, exp: "Experiment") -> None:
        """At every aligned chunk boundary (t_done rounds executed)."""

    def close(self, exp: "Experiment") -> None:
        """After the run."""


def eval_logits(params: Dict, model_cfg: ModelConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """The greedy eval's logits at the last position, [n, V] f32: the
    model's forward (the audio family's: zero frames [n, n_frontend_tokens,
    d_model] encoded, then the decoder; the vlm's runs without a prefix, as
    the reference's), then the lm head (or the tied embedding) on x[:, -1]
    only. `tasks.accuracy` reads no other position, and for
    recurrentgemma-2b the full [64, 64, 256000] logits would take 4.2 GB."""
    x = registry.get_module(model_cfg).forward(params, model_cfg, tokens)
    return L.unembed(L.head(params), x[:, -1])


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


class CheckpointHook(RoundHook):
    """Restore on start from the newest CRC-valid checkpoint, and save
    every `cadence` rounds through an `AsyncCheckpointer`
    (`double_buffer`: the snapshot's device-to-host copy is enqueued on the
    training stream into reused host buffers and written off-thread; False
    copies synchronously)."""

    def __init__(self, directory: str, every: int = 0,
                 double_buffer: bool = True):
        self.directory = directory
        self.cadence = every
        self.double_buffer = double_buffer
        self._saver: Optional[ckpt.AsyncCheckpointer] = None

    def on_start(self, exp: "Experiment") -> None:
        # the newest valid one: a torn step_N is skipped, not resumed from
        latest = ckpt.latest_valid(self.directory)
        if latest:
            exp.params, exp.start_round, extra = ckpt.restore(latest,
                                                              exp.params)
            exp.accountant = PrivacyAccountant.from_state_dict(
                extra["accountant"])
            exp.result.resumed_from = exp.start_round
        if self.cadence:
            self._saver = ckpt.AsyncCheckpointer(
                self.directory, double_buffer=self.double_buffer,
                injector=exp.injector)

    def on_boundary(self, t_done: int, exp: "Experiment") -> None:
        if self._saver is not None and t_done % self.cadence == 0:
            self._saver.save(
                t_done, exp.params,
                extra={"accountant": exp.accountant.state_dict(),
                       "round": t_done})

    def close(self, exp: "Experiment") -> None:
        if self._saver is not None:
            self._saver.wait()


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
    runs it), its Adam state made at the start of `run`, after the hooks'
    `on_start` (so a resumed FO run starts Adam afresh, as the reference
    does).

    `start_round` is where the rounds begin (a restoring hook sets it);
    `spent_at_start` and `hist_at_start` are the DP ledger's position
    then, from which `privacy_spent_per_round` folds."""

    def __init__(self, model_cfg: ModelConfig, pz: PairZeroConfig,
                 pipeline: FederatedPipeline, rounds: int, *,
                 engine: str = "loop", chunk_rounds: int = 32,
                 transport: Optional[tp.Transport] = None,
                 channel_model: Optional[channel.ChannelModel] = None,
                 hooks: Sequence[RoundHook] = (),
                 fault: Optional[FaultModel] = None,
                 elastic: Optional[ElasticSchedule] = None,
                 impl: Optional[str] = None, dtype=torch.float32,
                 params: Optional[Dict] = None, overlap: bool = True,
                 injector: Optional[inj.FaultInjector] = None,
                 device="cuda"):
        if engine not in ("scan", "loop"):
            raise ValueError(
                f"unknown engine: {engine!r} (want 'scan'|'loop')")
        if impl is not None:
            raise NotImplementedError(
                f"impl={impl!r} is not ported (ROADMAP {_IMPL_DTYPE}): the "
                "port runs its CUDA kernels on the card and their plain "
                "versions on the CPU")
        if not _is_f32(dtype):
            raise NotImplementedError(
                f"dtype={dtype!r} is not ported (ROADMAP {_IMPL_DTYPE}): "
                "the port trains in float32")
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
        self.fault = fault
        self.elastic = elastic
        self.injector = injector
        self.params = params
        self.result = RunResult()
        self.accountant = PrivacyAccountant(pz.dp.epsilon, pz.dp.delta)
        self.start_round = 0
        self.spent_at_start = 0.0
        self.hist_at_start = 0
        # bounded-retry counters by site, merged into result.retry_attempts
        self._retries: Dict[str, int] = {}

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
        # a restoring hook may have replaced the accountant: the ledger's
        # position now is what the per-round spend folds from
        self.spent_at_start = self.accountant.spent
        self.hist_at_start = len(self.accountant.history)
        start = self.start_round
        # the step's carry: the params, or under FO (params, Adam's state)
        carry = self.params if self.optimizer is None \
            else (self.params, self.optimizer.init(self.params))

        executor = eng.LoopExecutor(self.step) if self.engine == "loop" \
            else eng.get_executor(self.step)
        align = tuple(hk.cadence for hk in self.hooks if hk.cadence)
        # the loop engine dispatches (and syncs) one round at a time: one-
        # round chunks keep its metrics and on_round live
        span = 1 if self.engine == "loop" else self.chunk_rounds
        bounds = eng.chunk_boundaries(start, self.rounds, span, align)
        n_leaves = len(registry.shapes(self.model_cfg))
        stager = eng.BatchStager(self.pipeline, dev)
        # the worker thread's copies go to the stream the chunks run on
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None

        # the transport's random rows for every round left, in one draw
        draws = eng.draw_rows(self.transport, pz, start, self.rounds) \
            if bounds else {}

        def prepare(a: int, b: int):
            # chunks are prepared in round order, so the FaultModel's RNG
            # is drawn in round order
            with torch.cuda.stream(stream):
                trace = eng.build_trace(schedule, pz, a, b, device=dev,
                                        n_leaves=n_leaves,
                                        transport=self.transport,
                                        fault=self.fault,
                                        elastic=self.elastic,
                                        channel=ctrace,
                                        draws={k: v[a - start:b - start]
                                               for k, v in draws.items()})
                return trace, stager.stage(a, b)

        prefetch = eng.ChunkPrefetcher(prepare, bounds, overlap=self.overlap,
                                       injector=self.injector)
        # a dispatch is retried only for an injected fault, which fires at
        # its entry: a real failure mid-chunk has already updated the
        # params in place and cannot be replayed
        dispatch_attempts = 3 if (self.injector is not None
                                  and self.injector.armed("dispatch")) else 1
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
                carry, metrics = inj.with_retries(
                    lambda: executor.run(carry, trace.rows(n_ok), batches),
                    site="dispatch", attempts=dispatch_attempts,
                    injector=self.injector, retries=self._retries)
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
        # The reference's health monitor (checkpoint at the last boundary,
        # then abort) waits for the observability subsystem (ROADMAP A9).
        for hook in self.hooks:
            hook.close(self)

        result.steps = max(0, result.privacy_exhausted_at - start
                           if result.privacy_exhausted_at >= 0
                           else self.rounds - start)
        result.privacy_spent = self.accountant.spent
        costs = np.asarray(self.accountant.history[self.hist_at_start:],
                           dtype=np.float64)
        if costs.size != result.steps:
            costs = np.zeros(result.steps, dtype=np.float64)
        result.privacy_spent_per_round = cumulative_spend(
            costs, initial=self.spent_at_start)
        result.uplink_bits = tp.uplink_bits_total(
            self.transport, None, pz, self.model_cfg.param_count(),
            client_rounds, result.steps)
        result.prep_stall_s = prefetch.stall_s
        savers = [hk._saver for hk in self.hooks
                  if isinstance(hk, CheckpointHook) and hk._saver is not None]
        result.ckpt_stall_s = sum(s.stall_s for s in savers)
        # only nonzero counters: a clean run reports an empty dict
        attempts = dict(self._retries)
        attempts["prefetch_degraded"] = prefetch.degraded
        for saver in savers:
            for site, n in saver.retries.items():
                attempts[site] = attempts.get(site, 0) + n
            attempts["ckpt_write_failed"] = (
                attempts.get("ckpt_write_failed", 0) + saver.write_failures)
            attempts["ckpt_snapshot_failed"] = (
                attempts.get("ckpt_snapshot_failed", 0)
                + saver.snapshot_failures)
        result.retry_attempts = {k: v for k, v in attempts.items() if v}
        result.wall_time_s = time.time() - t0
        result.params = self.params
        if self.optimizer is not None:
            result.opt_state = carry[1]
        return result


def run(model_cfg: ModelConfig, pz: PairZeroConfig,
        pipeline: FederatedPipeline, rounds: int, *,
        engine: str = "loop", chunk_rounds: int = 32,
        eval_every: int = 0, eval_n: int = 64,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
        fault: Optional[FaultModel] = None,
        elastic: Optional[ElasticSchedule] = None,
        impl: Optional[str] = None, dtype=torch.float32,
        params: Optional[Dict] = None,
        on_round: Optional[Callable[[int, Dict], None]] = None,
        transport: Optional[tp.Transport] = None,
        channel_model: Optional[channel.ChannelModel] = None,
        overlap: bool = True, hooks: Sequence[RoundHook] = (),
        injector: Optional[inj.FaultInjector] = None,
        variant: Optional[str] = None, scheme: Optional[str] = None,
        device="cuda", **unported) -> RunResult:
    """Run `rounds` rounds of pAirZero on one device (default: the GPU).

    Mirrors `repro.core.fedsim.run`: `engine="scan"` runs chunks of up to
    `chunk_rounds` rounds (one captured CUDA graph replayed per round on the
    card), `eval_every` adds an `EvalHook` (accuracies on `eval_n` held-out
    sequences), `checkpoint_dir` a `CheckpointHook` (resume from the newest
    valid checkpoint there, save every `checkpoint_every` rounds), `fault`
    and `elastic` mask clients out of rounds, `injector` arms the host
    fault-injection sites, `overlap=False` prepares each chunk inline
    instead of on the prefetch thread. `variant=`/`scheme=` are the
    reference's deprecated string spellings, routed through the transport
    registry with its DeprecationWarning. `device="cpu"` runs the plain
    PyTorch versions of the kernels (the tests' path); "cuda" raises when
    no GPU is present."""
    for option, value in unported.items():
        if option not in _UNPORTED:
            raise TypeError(f"run() got an unexpected keyword argument "
                            f"{option!r}")
        _reject(option, value)
    if variant is not None or scheme is not None:
        tp.deprecated_strings(variant or pz.variant,
                              scheme or pz.power.scheme, "fedsim.run")
        pz = dataclasses.replace(
            pz, variant=variant or pz.variant,
            power=dataclasses.replace(pz.power,
                                      scheme=scheme or pz.power.scheme),
            transport=None)
    all_hooks: List[RoundHook] = list(hooks)
    if eval_every:
        all_hooks.append(EvalHook(eval_every, eval_n))
    if checkpoint_dir:
        all_hooks.append(CheckpointHook(checkpoint_dir, checkpoint_every))
    if on_round is not None:
        all_hooks.append(CallbackHook(on_round))
    return Experiment(model_cfg, pz, pipeline, rounds, engine=engine,
                      chunk_rounds=chunk_rounds, transport=transport,
                      channel_model=channel_model, hooks=all_hooks,
                      fault=fault, elastic=elastic, impl=impl, dtype=dtype,
                      params=params, overlap=overlap, injector=injector,
                      device=device).run()


def _is_f32(dtype) -> bool:
    """Whether `dtype` (a torch dtype, or anything numpy reads as one,
    such as `np.float32` or "float32") is float32."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False
