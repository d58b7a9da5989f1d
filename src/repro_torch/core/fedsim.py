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

The reference's scenario axes run as its do: `adversary` (a
`privacy.Adversary`: the round's `obs_*` metrics, which an `AttackHook`
collects), `behavior`/`defense` (`byzantine`; default: resolved from
`pz.byzantine`, a defense also solving the schedule and pricing the
rounds) and `desync` (`runtime.desync`; default: resolved from
`pz.desync`, an inert model meaning none). Options of the reference that
this port does not carry yet raise NotImplementedError naming their
ROADMAP item; none is ignored.

`impl=` and `dtype=` are the reference's. `impl` names the kernels'
implementation for the whole run, eval included (`kernels.ops.use_impl`:
None by device, "pallas" the CUDA kernels, "xla", "xla_chunked",
"xla_full" and "pallas_interpret" the plain versions on either device).
`dtype` is the parameters' (float32, or bfloat16 named any way the
reference takes it): the initial weights are drawn in f32 and rounded
(or, when `params` are passed, the leaves' own dtype counts), and the
chained walk rounds at every step, as the reference's. What this port
does not hold against the reference in bf16 raises NotImplementedError
naming ROADMAP A12: families other than the dense one, MLA and MoE
(`registry.check_dtype`), the FO transport, and checkpoints.

Observability (`obs`) rides the same loop: `telemetry` (an
`obs.Telemetry`) records the span timeline (channel_realize,
schedule_solve, params_init, ctl_build, chunk, dispatch, metrics_flush,
hooks_boundary and the prefetcher's, stager's, checkpointer's and
injector's own), samples device memory at chunk boundaries
(`RunResult.peak_bytes`) and with `cost=True` counts the first round's
operations and bytes (`RunResult.cost_stats`); `RunResult.compile_stats`
always reports the run's step and executor builds and graph captures. A
`MetricsSink` hook streams the trilemma ledger, a `HealthMonitor` hook
watches the losses: under its abort policy the run stops at the chunk that
delivered the bad round, a `CheckpointHook`'s saver writes the weights
and the ledger at the last completed boundary, and `RunResult` carries
the abort (`health_abort_round`, `health_abort_reason`). All of it only
observes: telemetry on runs bitwise the run with it off.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import byzantine as byz
from repro_torch import A12, channel, obs, prng, resolve_device, resolve_dtype
from repro_torch.configs.base import ModelConfig, PairZeroConfig
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import engine as eng
from repro_torch.core import pairzero
from repro_torch.core import transport as tp
from repro_torch.core import zo
from repro_torch.core.dp import PrivacyAccountant, cumulative_spend
from repro_torch.data import tasks as T
from repro_torch.data.pipeline import FederatedPipeline
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.optim import fo as fo_opt
from repro_torch.runtime import desync as dsync
from repro_torch.runtime import inject as inj
from repro_torch.runtime.fault import ElasticSchedule, FaultModel

# reference options not ported yet → the ROADMAP item that ports them
_UNPORTED = {
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
    resumed_from: int = 0            # the round a restored checkpoint held
    prep_stall_s: float = 0.0        # driver blocked on host-side chunk prep
    ckpt_stall_s: float = 0.0        # driver blocked in checkpoint snapshots
    # nonzero retry / degradation counters by site ("dispatch",
    # "ckpt_write", "prefetch_degraded", "ckpt_write_failed",
    # "ckpt_snapshot_failed"); empty on a clean run
    retry_attempts: Dict[str, int] = field(default_factory=dict)
    # observability (obs): the device-memory watermark (0: no sampler)
    peak_bytes: int = 0
    # build and capture counter deltas for this run (obs.retrace; always
    # recorded: a warm rerun on the same parameters shows all zeros)
    compile_stats: Dict[str, int] = field(default_factory=dict)
    # the first round's operations, bytes and peak (obs.cost), when the
    # run's Telemetry has cost=True
    cost_stats: Optional[Dict[str, Any]] = None
    # a HealthMonitor abort: its round and detector; -1 / "" otherwise.
    # The accountant charged only executed rounds, so privacy_spent is the
    # realized spend
    health_abort_round: int = -1
    health_abort_reason: str = ""


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
                tracer=exp.telemetry.tracer, injector=exp.injector)

    def on_boundary(self, t_done: int, exp: "Experiment") -> None:
        if self._saver is not None and t_done % self.cadence == 0:
            self._saver.save(
                t_done, exp.params,
                extra={"accountant": exp.accountant.state_dict(),
                       "round": t_done})

    def close(self, exp: "Experiment") -> None:
        if self._saver is not None:
            self._saver.wait()


class _BoundaryCopy:
    """The weights at the newest chunk boundary, for checkpoint-then-abort.

    The leaves are updated in place, so when a health abort surfaces (one
    chunk late under scan) the next chunk has already moved them. `take`
    copies every leaf, in stream order before the next dispatch, into host
    buffers of the driver's own (pinned for leaves on the card; the
    checkpointer's own buffers may be in use by its writer), allocated
    once and reused; `weights` waits for the last copy and returns them in
    the params' structure."""

    def __init__(self):
        self._buffers: Optional[List[torch.Tensor]] = None
        self._like = None
        self._copied: Optional[torch.cuda.Event] = None

    def take(self, params) -> None:
        _, leaves = ckpt._leaf_paths(params)
        if self._buffers is None:
            self._buffers = [torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=t.is_cuda)
                             for t in leaves]
        for buf, leaf in zip(self._buffers, leaves, strict=True):
            buf.copy_(leaf.detach(), non_blocking=True)
        self._like = params
        self._copied = None
        if any(t.is_cuda for t in leaves):
            self._copied = torch.cuda.Event()
            self._copied.record()

    def weights(self):
        if self._copied is not None:
            self._copied.synchronize()
        return ckpt._unflatten(self._like, self._buffers)


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
    then, from which `privacy_spent_per_round` folds. `round_k_eff` and
    `round_k_sync` list, per executed round, the clients the mask admitted
    and those of them on the current round seed (the ledger's columns).

    `telemetry` (an `obs.Telemetry`, default off) is read by the run and
    its hooks. `compile_stats` counts from the construction, which builds
    the round body. `impl` and `dtype` as for `run`."""

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
                 adversary=None, behavior=None, defense=None,
                 desync: Optional[dsync.DesyncModel] = None,
                 injector: Optional[inj.FaultInjector] = None,
                 telemetry: Optional[obs.Telemetry] = None,
                 device="cuda"):
        self._compile_before = obs.retrace.snapshot()
        if engine not in ("scan", "loop"):
            raise ValueError(
                f"unknown engine: {engine!r} (want 'scan'|'loop')")
        self.impl = kops.check_impl(impl)
        self.dtype = resolve_dtype(dtype)
        # the parameters' dtype: the leaves' own when they are passed
        leaves = [t for _, t in zo.flatten(params)] if params else []
        theta_dtype = leaves[0].dtype if leaves else self.dtype
        registry.check_dtype(model_cfg, theta_dtype)
        self.device = resolve_device(device)
        if self.impl == "pallas" and self.device.type != "cuda":
            raise ValueError("impl='pallas' runs the CUDA kernels, which "
                             f"have no {self.device.type} version")
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
        self.adversary = adversary
        # explicit instances override the pz.byzantine / pz.desync configs
        self.behavior = behavior if behavior is not None \
            else byz.resolve_behavior(pz)
        self.defense = defense if defense is not None \
            else byz.resolve_defense(pz)
        self.desync = desync if desync is not None else dsync.resolve(pz)
        if self.desync is not None and not self.desync.active:
            self.desync = None     # an inert model is the synchronized run
        if self.transport.kind == "fo" and (self.behavior is not None
                                            or self.defense is not None):
            raise ValueError(
                "Byzantine behaviors/defenses act on the scalar ZO payload "
                "vector; the FO baseline has no scalar uplink to attack or "
                "defend — run it without a ByzantineConfig")
        if theta_dtype != torch.float32:
            if self.transport.kind == "fo":
                raise NotImplementedError(
                    f"the fo transport in {theta_dtype} is not ported "
                    f"({A12})")
            if any(isinstance(hk, CheckpointHook) for hk in hooks):
                raise NotImplementedError(
                    f"checkpoints of a {theta_dtype} θ are not ported "
                    f"({A12}): the reference writes bf16 leaves as '<V2' "
                    ".npy files")
        if self.transport.kind == "fo":
            # the reference's FO baseline: FO-Adam at the ZO learning rate
            self.optimizer = fo_opt.make("adam", pz.zo.lr)
            self.step = pairzero.make_fo_step(
                model_cfg, self.optimizer, adversary=self.adversary,
                desync=self.desync)
        else:
            self.optimizer = None
            self.step = pairzero.make_zo_step(
                model_cfg, pz, self.transport, adversary=self.adversary,
                behavior=self.behavior, defense=self.defense,
                desync=self.desync)
        self.hooks = list(hooks)
        self.fault = fault
        self.elastic = elastic
        self.injector = injector
        self.params = params
        self.telemetry = telemetry if telemetry is not None \
            else obs.Telemetry.off()
        self.result = RunResult()
        self.accountant = PrivacyAccountant(pz.dp.epsilon, pz.dp.delta)
        self.start_round = 0
        self.spent_at_start = 0.0
        self.hist_at_start = 0
        self.round_k_eff: List[float] = []
        self.round_k_sync: List[float] = []
        # bounded-retry counters by site, merged into result.retry_attempts
        self._retries: Dict[str, int] = {}

    def run(self) -> RunResult:
        with kops.use_impl(self.impl):
            return self._run()

    def _run(self) -> RunResult:
        t0 = time.time()
        pz, result, dev = self.pz, self.result, self.device
        tr, mem = self.telemetry.tracer, self.telemetry.memory
        result.privacy_budget = self.accountant.budget
        # channel + schedule over the PLANNED horizon (Theorem 3 budgets
        # privacy across all T), exactly as the reference realizes them
        horizon = max(pz.rounds, self.rounds)
        with tr.span("channel_realize", horizon=horizon):
            ctrace = self.channel_model.realize(pz.seed ^ 0xC4A7, horizon,
                                                pz.n_clients)
        # a defense may fold its PHY constraint into the solve
        with tr.span("schedule_solve", transport=self.transport.name):
            schedule = self.transport.make_schedule(ctrace, pz) \
                if self.defense is None \
                else self.defense.make_schedule(self.transport, ctrace, pz)
        result.schedule, result.transport = schedule, self.transport
        if self.params is None:
            with tr.span("params_init"):
                self.params = registry.init_params(
                    self.model_cfg, prng.key(pz.seed), dev, self.dtype)
        for hook in self.hooks:
            hook.on_start(self)
        # a restoring hook may have replaced the accountant: the ledger's
        # position now is what the per-round spend folds from
        self.spent_at_start = self.accountant.spent
        self.hist_at_start = len(self.accountant.history)
        start = self.start_round
        if mem is not None:
            mem.sample(start, tracer=tr, device=dev)
        # the step's carry: the params, or under FO (params, Adam's state)
        carry = self.params if self.optimizer is None \
            else (self.params, self.optimizer.init(self.params))

        executor = eng.get_loop_executor(self.step) \
            if self.engine == "loop" else eng.get_executor(self.step)
        align = tuple(hk.cadence for hk in self.hooks if hk.cadence)
        # the loop engine dispatches (and syncs) one round at a time: one-
        # round chunks keep its metrics and on_round live
        span = 1 if self.engine == "loop" else self.chunk_rounds
        bounds = eng.chunk_boundaries(start, self.rounds, span, align)
        n_leaves = len(registry.shapes(self.model_cfg))
        stager = eng.BatchStager(self.pipeline, dev, tracer=tr)
        # the worker thread's copies go to the stream the chunks run on
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None

        # the round's random rows for every round left, in one draw
        draws = eng.draw_rows(self.transport, pz, start, self.rounds,
                              self.behavior, self.defense) \
            if bounds else {}

        def prepare(a: int, b: int):
            # chunks are prepared in round order, so the FaultModel's RNG
            # is drawn in round order
            with torch.cuda.stream(stream):
                with tr.span("ctl_build", t0=a, t1=b):
                    trace = eng.build_trace(
                        schedule, pz, a, b, device=dev, n_leaves=n_leaves,
                        transport=self.transport, fault=self.fault,
                        elastic=self.elastic, channel=ctrace,
                        draws={k: v[a - start:b - start]
                               for k, v in draws.items()},
                        behavior=self.behavior, defense=self.defense,
                        desync=self.desync)
                return trace, stager.stage(a, b)

        prefetch = eng.ChunkPrefetcher(prepare, bounds, overlap=self.overlap,
                                       injector=self.injector, tracer=tr)
        # a dispatch is retried only for an injected fault, which fires at
        # its entry: a real failure mid-chunk has already updated the
        # params in place and cannot be replayed
        dispatch_attempts = 3 if (self.injector is not None
                                  and self.injector.armed("dispatch")) else 1
        # checkpoint-then-abort: with an abort-policy monitor and a saver,
        # the weights of each boundary are kept on the host (the leaves
        # move in place before an abort surfaces)
        savers = [hk._saver for hk in self.hooks
                  if isinstance(hk, CheckpointHook) and hk._saver is not None]
        boundary = _BoundaryCopy() if savers and any(
            getattr(hk, "policy", None) == "abort" for hk in self.hooks) \
            else None
        if boundary is not None:
            boundary.take(self.params)
        # the first dispatched round's cost, counted as it runs
        cost = obs.cost.RoundCost(dev) if self.telemetry.cost else None
        # software pipelining: chunk i-1's metrics are synced after chunk i
        # has been dispatched, so the sync overlaps the device's work
        pending = None            # (first_round, n_rounds, metrics)
        client_rounds = 0.0
        # a HealthMonitor(policy="abort") raises from on_round inside a
        # flush; caught at chunk granularity, so executed == charged rounds
        health_abort: Optional[obs.HealthAbort] = None
        last_boundary = start     # the newest completed hook boundary

        def flush() -> None:
            nonlocal pending
            if pending is None:
                return
            a0, n_rounds, metrics = pending
            pending = None
            with tr.span("metrics_flush", t0=a0, rounds=n_rounds):
                host = {k: v.cpu().numpy() for k, v in metrics.items()}
                result.losses.extend(float(x) for x in host["loss"])
                if "p_hat" in host:             # FO has no scalar uplink
                    result.p_hats.extend(float(x) for x in host["p_hat"])
                for hook in self.hooks:
                    for r in range(n_rounds):
                        hook.on_round(a0 + r,
                                      {k: v[r] for k, v in host.items()})

        try:
            for i, (a, b) in enumerate(bounds):
                with tr.span("chunk", chunk=i, t0=a, t1=b):
                    trace, batches = prefetch.get(i)
                    n_ok = eng.affordable_rounds(self.accountant, trace)
                    if n_ok == 0:
                        result.privacy_exhausted_at = a
                        break
                    eng.charge_rounds(self.accountant, trace, n_ok)
                    # the clients each round's mask admits (the uplink
                    # bill), and those of them on the current round seed
                    masks = trace.host_masks[:n_ok]
                    k_rows = masks.sum(axis=1)
                    client_rounds += float(k_rows.sum())
                    self.round_k_eff.extend(float(x) for x in k_rows)
                    sync_rows = k_rows if trace.host_stale is None else (
                        masks * (1.0 - trace.host_stale[:n_ok])).sum(axis=1)
                    self.round_k_sync.extend(float(x) for x in sync_rows)
                    if n_ok < b - a:      # guard trips mid-chunk: truncate
                        batches = {k: v[:n_ok] for k, v in batches.items()}
                    probe = cost if i == 0 else None
                    with tr.span("dispatch", chunk=i, rounds=n_ok):
                        carry, metrics = inj.with_retries(
                            lambda: executor.run(carry, trace.rows(n_ok),
                                                 batches, probe),
                            site="dispatch", attempts=dispatch_attempts,
                            injector=self.injector, tracer=tr,
                            retries=self._retries)
                    self.params = carry if self.optimizer is None \
                        else carry[0]
                    flush()               # sync chunk i-1 while chunk i runs
                    # pending holds the chunk's metrics alone, so they are
                    # freed once flushed (an FO capture's are θ-sized)
                    pending, metrics = (a, n_ok, metrics), None
                    if self.engine == "loop":
                        flush()           # per-round dispatch: deliver now
                    # chunk i-1 is synced, so its stager slot (shared with
                    # chunk i+1) may be rewritten: start the next one
                    prefetch.kick(i + 1)
                    t_done = a + n_ok
                    if n_ok < b - a:      # guard tripped mid-chunk: stop
                        flush()
                        result.privacy_exhausted_at = t_done
                        break
                    if mem is not None and mem.due(t_done):
                        mem.sample(t_done, tracer=tr, device=dev)
                    with tr.span("hooks_boundary", t=t_done):
                        for hook in self.hooks:
                            hook.on_boundary(t_done, self)
                    if boundary is not None:
                        boundary.take(self.params)
                    last_boundary = t_done
        except obs.HealthAbort as e:
            health_abort = e
            pending = None        # rounds past the abort stay unreported
        finally:
            prefetch.close()
        # the final watermark BEFORE the last flush: the ledger's rows and
        # result.peak_bytes then report the same peak
        if mem is not None:
            mem.sample(start + len(self.round_k_eff), tracer=tr, device=dev)
        if health_abort is None:
            try:
                flush()
            except obs.HealthAbort as e:
                health_abort = e
                pending = None
        if health_abort is not None:
            result.health_abort_round = int(health_abort.round)
            result.health_abort_reason = str(health_abort.reason)
            # checkpoint-then-abort: the weights and the ledger at the last
            # completed boundary; best effort, the abort report must
            # survive a failing writer
            weights = boundary.weights() if boundary is not None \
                else self.params
            for saver in savers:
                try:
                    saver.save(last_boundary, weights,
                               extra={"accountant":
                                      self.accountant.state_dict(),
                                      "round": last_boundary})
                except Exception:  # noqa: BLE001 - keep the abort report
                    pass
        for hook in self.hooks:
            hook.close(self)

        if health_abort is not None:
            # every charged round executed: the aborting chunk's rounds
            # were bought and ran
            result.steps = len(self.round_k_eff)
        else:
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
            self.transport, self.defense, pz, self.model_cfg.param_count(),
            client_rounds, result.steps)
        result.prep_stall_s = prefetch.stall_s
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
        result.peak_bytes = mem.peak_bytes if mem is not None else 0
        result.compile_stats = obs.retrace.since(self._compile_before)
        if cost is not None and cost.stats() is not None:
            result.cost_stats = cost.stats().to_dict()
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
        overlap: bool = True, adversary=None, behavior=None, defense=None,
        hooks: Sequence[RoundHook] = (),
        desync: Optional[dsync.DesyncModel] = None,
        injector: Optional[inj.FaultInjector] = None,
        telemetry: Optional[obs.Telemetry] = None,
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
    instead of on the prefetch thread. `adversary=` (a
    `privacy.Adversary`) switches on the eavesdropper's capture (collect
    it with a `privacy.AttackHook` in `hooks=`); `behavior=`/`defense=`
    and `desync=` override `pz.byzantine` and `pz.desync`. `telemetry=`
    (an `obs.Telemetry`) switches on the span timeline, the memory
    watermark and (`cost=True`) the first round's cost; pair it with an
    `obs.MetricsSink` in `hooks=` for the trilemma ledger, and add an
    `obs.HealthMonitor` to watch the losses. All of it only observes.
    `variant=`/`scheme=` are the reference's deprecated string spellings,
    routed through the transport registry with its DeprecationWarning.
    `device="cpu"` runs the plain PyTorch versions of the kernels (the
    tests' path); "cuda" raises when no GPU is present. `impl=` names the
    kernels' implementation (`kernels.ops.IMPLS`; "xla" runs the plain
    versions on the card too, "pallas" the kernels and refuses the CPU)
    and `dtype=` the parameters' (float32, or bfloat16 for the dense
    family's GQA models), as the reference's do."""
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
                      params=params, overlap=overlap, adversary=adversary,
                      behavior=behavior, defense=defense, desync=desync,
                      injector=injector, telemetry=telemetry,
                      device=device).run()

