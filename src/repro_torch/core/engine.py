"""Round executors, ported from `repro.core.engine`: per-round dispatch
(loop) and one captured CUDA graph replayed over a chunk of rounds (scan).

A pAirZero trajectory is a pure function of (params, seeds, schedule): the
per-round control — c(t), σ(t), the round's leaf seeds, the survival mask,
the CSI factors and the OTA noise — is known once the base station has
solved the power schedule. `build_trace` stacks it for a chunk of rounds
and ships it to the device in one transfer; `BatchStager` does the same
for the chunk's batches through slot-rotated host buffers;
`ChunkPrefetcher` prepares chunk i+1 on a worker thread while the device
runs chunk i. `LoopExecutor` walks a chunk one round at a time;
`ScanExecutor` runs a chunk's first round eagerly, then replays one
captured round for the rest. Both call the same round body on the same
inputs, so `engine="scan"` and `engine="loop"` give the same bits.

The host keeps the DP accounting: the run's Transport prices each round
and the hard privacy stop truncates a chunk at the first round that would
overspend.

The random draws a transport reads are data here, made on the host with
the reference's own threefry draws (`repro_torch.prng`) from the keys the
reference derives: round t's key is fold_in(key(seed ^ 0x5EED), t),
direction j's fold_in(round key, j). `noise_rows` gives the OTA normals
and `uniform_rows` the digital dither, each a pure function of (seed, t),
so a trace does not depend on how rounds are chunked; a Byzantine
behavior's and a defense's rows come from the same keys (`draw_rows`),
and a desync model adds its rows (`runtime.desync`).
"""
from __future__ import annotations

import contextlib
import functools
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.byzantine.behaviors import BYZ_KEY_TAG
from repro_torch.core import transport as tp
from repro_torch.core import zo
from repro_torch.core.dp import PrivacyAccountant
from repro_torch.kernels import ops as kops
from repro_torch.obs import retrace
from repro_torch.obs import spans as ob
from repro_torch.runtime.fault import combined_mask

Params = Dict

#: rounds run by replaying a captured graph since the last reset (set to 0
#: to reset): a run shows with it that the graph, not an eager loop, ran them
replays = 0


@dataclass
class ControlTrace:
    """Stacked per-round control for rounds [t0, t0+R).

    `ctl` holds seed [R] (the round seeds, a host uint32 array kept for the
    record: the round body reads none of it) and device tensors c [R],
    sigma [R,K], n0 [R], mask [R,K], g [R,K], leaf_seeds [R, n_perturb,
    n_leaves] (int32 holding the uint32 bits of
    leaf_seed(perturb_seed(round_seed(seed, t), j), i)) and the draws the
    transport reads (`Transport.draws`): noise [R, n_perturb, K+1] and
    uniform [R, n_perturb, K], with a Byzantine behavior's and a defense's
    rows beside them ([R, n_perturb, ...]) and a desync model's
    (`runtime.desync`). `host_masks` is the host view of the mask for the
    uplink-bit accounting; `host_stale` the stale rows under desync."""
    t0: int
    ctl: Dict
    acct_cost: np.ndarray     # [R] per-round DP cost
    charged: bool             # whether these rounds cost privacy at all
    host_masks: Optional[np.ndarray] = None
    host_stale: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(len(self.ctl["seed"]))

    def rows(self, n: int) -> Dict:
        """First n rounds of the stacked control block."""
        if n == len(self):
            return self.ctl
        return {k: v[:n] for k, v in self.ctl.items()}


def direction_keys(seed: int, t0: int, t1: int,
                   n_perturb: int) -> torch.Tensor:
    """[R, n_perturb, 2] round keys of rounds [t0, t1): direction j of round
    t has fold_in(fold_in(key(seed ^ 0x5EED), t), j), the reference's
    `round_key` (`repro.core.pairzero.make_control` and its round body)."""
    base = prng.key(int(seed) ^ 0x5EED)
    rounds = prng.fold_in(base, torch.arange(t0, t1))
    return prng.fold_in(rounds[:, None, :], torch.arange(n_perturb))


def noise_rows(seed: int, t0: int, t1: int, n_perturb: int,
               n_clients: int) -> np.ndarray:
    """[R, n_perturb, K+1] f32 standard normals for rounds [t0, t1): per
    direction, the K artificial-noise draws normal(nk, (K,)), then the
    receiver-noise draw normal(zk, ()), with nk, zk = split(round key), as
    `repro.core.ota.superpose` draws them (`transport.key_draws`)."""
    return tp.key_draws(("noise",), direction_keys(seed, t0, t1, n_perturb),
                        n_clients)["noise"].numpy()


def uniform_rows(seed: int, t0: int, t1: int, n_perturb: int,
                 n_clients: int) -> np.ndarray:
    """[R, n_perturb, K] f32 uniforms on [0, 1) for rounds [t0, t1):
    uniform(round key, (K,)), the digital transports' dither
    (`repro.core.transport.stochastic_quantize`)."""
    return tp.key_draws(("uniform",), direction_keys(seed, t0, t1,
                                                     n_perturb),
                        n_clients)["uniform"].numpy()


class HostBlock:
    """Host arrays laid out in one byte buffer (each 16-byte aligned, pinned
    when the target is the card), shipped to the device in one copy.

    `host` holds numpy views to fill; `ship` returns device views of the
    same layout. On the CPU `ship` returns views of the host buffer itself
    (nothing is copied), so what it returned is valid only until the buffer
    is refilled."""

    def __init__(self, like: Dict[str, Tuple[tuple, np.dtype]],
                 device: torch.device):
        self.device = device
        self.signature = _signature(like)
        self._layout = {}
        size = 0
        for key, (shape, dtype) in like.items():
            n = math.prod(shape) * np.dtype(dtype).itemsize
            self._layout[key] = (size, n, tuple(shape), np.dtype(dtype))
            size += -(-n // 16) * 16
        self._buf = torch.empty(max(size, 16), dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        raw = self._buf.numpy()
        self.host = {k: raw[o:o + n].view(dt).reshape(shape)
                     for k, (o, n, shape, dt) in self._layout.items()}
        self._copied: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        """Block until the last copy out of the buffer has completed (then
        the buffer may be refilled)."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None

    def ship(self) -> Dict[str, torch.Tensor]:
        """One non-blocking copy of the whole buffer to the device, on the
        current stream; the device views of each array."""
        dev = self._buf.to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return {k: dev[o:o + n].view(_torch_dtype(dt)).view(shape)
                for k, (o, n, shape, dt) in self._layout.items()}


def _signature(like: Dict[str, Tuple[tuple, Any]]) -> tuple:
    return tuple((k, tuple(shape), np.dtype(dt).str)
                 for k, (shape, dt) in like.items())


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def draw_rows(transport: tp.Transport, pz, t0: int, t1: int,
              behavior=None, defense=None) -> Dict[str, np.ndarray]:
    """The random rows the round reads for rounds [t0, t1), by name: the
    transport's (`Transport.draws`), a behavior's from the attack keys
    fold_in(round key, BYZ_KEY_TAG) and a defense's, each [R, n_perturb,
    ...] from the direction keys."""
    draws = {"noise": noise_rows, "uniform": uniform_rows}
    rows = {name: draws[name](pz.seed, t0, t1, pz.zo.n_perturb,
                              pz.n_clients) for name in transport.draws}
    if behavior is None and defense is None:
        return rows
    keys = direction_keys(pz.seed, t0, t1, pz.zo.n_perturb)
    if behavior is not None:
        rows.update(behavior.draw_rows(prng.fold_in(keys, BYZ_KEY_TAG),
                                       pz.n_clients))
    if defense is not None:
        rows.update(defense.draw_rows(transport, keys, pz.n_clients))
    return rows


def build_trace(schedule, pz, t0: int, t1: int, *, device, n_leaves: int,
                transport: Optional[tp.Transport] = None,
                fault=None, elastic=None, channel=None,
                draws: Optional[Dict[str, np.ndarray]] = None,
                behavior=None, defense=None, desync=None
                ) -> ControlTrace:
    """Precompute the control trace for rounds [t0, t1), shipped to
    `device` in one non-blocking copy.

    The mask rows compose as the reference's do: `combined_mask` of the
    `fault` (a `runtime.FaultModel`) and `elastic` (a
    `runtime.ElasticSchedule`) models per round, which draws the stateful
    FaultModel RNG in round order, so consecutive chunks replay the
    per-round draw; then the channel's deep-fade participation; then a
    round that this leaves empty re-admits its strongest client among
    those the faults left up. `channel` is the horizon's realized
    ChannelTrace: its cos θ CSI factors (the cosine taken in float64)
    become ctl["g"]. No models and no channel (or a perfect-CSI, no-outage
    trace) give all-ones rows. The leaf seeds of every round and direction
    (`zo.seed_table`) come from numpy on the host. `draws` are the
    transport's random rows for [t0, t1) when the caller drew them ahead
    (`draw_rows`; a run draws its whole horizon in one go, since a draw
    costs about the same few hundred small CPU ops for one round as for
    a thousand); None draws them here.

    `behavior` (a `byzantine.ClientBehavior`) adds its cohort as ctl["byz"]
    [R, K]; `defense` (a `byzantine.Defense`) prices the rounds' privacy;
    `desync` (a `runtime.desync.DesyncModel`) adds dsync_seed (host),
    dsync_stale, dsync_a, dsync_frame [R, K], the lagged seed's leaf seeds
    dsync_leaf_seeds [R, n_perturb, n_leaves] and, under FO, the
    interference keys dsync_ici_keys [R, n_leaves, 2]. None for each
    leaves the trace as it was, bit for bit."""
    if transport is None:
        transport = tp.resolve(pz)
    device = torch.device(device)
    k = pz.n_clients
    rounds = int(t1 - t0)
    if fault is None and elastic is None:
        masks = np.ones((rounds, k), dtype=np.float32)
    else:
        masks = np.stack([combined_mask(t, fault, elastic, n_clients=k)
                          for t in range(t0, t1)])
    if channel is None:
        g = np.ones((rounds, k), dtype=np.float32)
    else:
        g = np.asarray(np.cos(channel.phase[t0:t1]), dtype=np.float32)
        survival = masks                # the fault/elastic view
        masks = masks * np.asarray(channel.participation[t0:t1], np.float32)
        # outage × faults can empty a round that neither empties alone:
        # re-admit the strongest client the faults left up (never one
        # that crashed)
        empty = np.flatnonzero(masks.sum(axis=1) == 0)
        if empty.size:
            h_rows = np.asarray(channel.h[t0:t1])[empty] * survival[empty]
            masks[empty, np.argmax(h_rows, axis=1)] = 1.0
    host_ctl = {
        "c": np.asarray(schedule.c[t0:t1], dtype=np.float32),
        "sigma": np.asarray(schedule.sigma[t0:t1], dtype=np.float32),
        "n0": np.full((rounds,), schedule.n0, dtype=np.float32),
        "mask": masks,
        "g": g,
        "leaf_seeds": zo.seed_table(pz.seed, t0, t1, pz.zo.n_perturb,
                                    n_leaves).view(np.int32),
    }
    host_ctl.update(draw_rows(transport, pz, t0, t1, behavior, defense)
                    if draws is None else draws)
    if behavior is not None:
        host_ctl["byz"] = np.broadcast_to(
            behavior.client_mask(k)[None, :], (rounds, k)).copy()
    host_stale = lagged = None
    if desync is not None:
        from repro_torch.runtime import desync as ds
        dsync, host_stale = ds.control_rows(desync, pz.seed, t0, t1, k)
        lagged = dsync.pop("dsync_seed")
        host_ctl.update(dsync)
        host_ctl["dsync_leaf_seeds"] = zo.leaf_seed_table(
            lagged, pz.zo.n_perturb, n_leaves).view(np.int32)
        if transport.kind == "fo":
            host_ctl["dsync_ici_keys"] = ds.ici_keys(pz.seed, t0, t1,
                                                     n_leaves)
    block = HostBlock({key: (v.shape, v.dtype) for key, v in
                       host_ctl.items()}, device)
    for key, v in host_ctl.items():
        block.host[key][...] = v
    ctl = block.ship()
    ctl["seed"] = np.asarray([zo.round_seed(pz.seed, t)
                              for t in range(t0, t1)], dtype=np.uint32)
    if lagged is not None:
        ctl["dsync_seed"] = lagged
    if defense is not None:
        charged = bool(defense.charges_privacy(transport, schedule, pz))
        acct_cost = defense.round_dp_costs(transport, schedule, t0, t1, pz) \
            if charged else np.zeros(rounds)
    else:
        charged = bool(transport.charges_privacy(schedule, pz))
        acct_cost = transport.round_dp_costs(schedule, t0, t1, pz) \
            if charged else np.zeros(rounds)
    return ControlTrace(t0=t0, ctl=ctl, acct_cost=acct_cost, charged=charged,
                        host_masks=masks, host_stale=host_stale)


def affordable_rounds(accountant: PrivacyAccountant, trace: ControlTrace,
                      slack: float = 1e-6) -> int:
    """How many leading rounds of `trace` the DP budget affords (pure
    lookahead, the same float64 left fold as the reference)."""
    if not trace.charged:
        return len(trace)
    costs = np.asarray(trace.acct_cost, dtype=np.float64)
    cum = np.cumsum(np.concatenate(([accountant.spent], costs)))
    over = np.flatnonzero(cum[1:] > accountant.budget * (1.0 + slack))
    return int(over[0]) if over.size else len(trace)


def charge_rounds(accountant: PrivacyAccountant, trace: ControlTrace,
                  n: int) -> None:
    """Charge the accountant for the first n rounds of the trace."""
    if not trace.charged or n <= 0:
        return
    accountant.spend_batch(np.asarray(trace.acct_cost[:n], dtype=np.float64))


# ---------------------------------------------------------------------------
# Batch staging (host → device, one transfer per chunk)
# ---------------------------------------------------------------------------

class BatchStager:
    """Slot-rotated host staging for chunk batches.

    Each slot keeps one `HostBlock` (pinned on the card); a chunk's batches
    are stacked into it in place, token ids widened to int64 for indexing,
    labels dropped, and shipped in one non-blocking copy.

    Slots exist because the prefetch thread prepares chunk i+1 while chunk
    i may still run. The lifetime rule is the reference's: on the CPU the
    staged tensors ALIAS the host buffer, so they are valid only until their
    slot is rewritten (two `stage` calls later), and the driver kicks chunk
    i+1's preparation only after chunk i-1 has been synced
    (`ChunkPrefetcher.kick`); on the card a slot is also rewritten only
    after its last copy has completed. Each `stage` runs in a
    ``batch_stage`` span on `tracer`."""

    def __init__(self, pipeline, device, slots: int = 2,
                 tracer: ob.Tracer = ob.NULL_TRACER):
        self._pipeline = pipeline
        self._device = torch.device(device)
        self._slots: List[Optional[HostBlock]] = [None] * max(1, slots)
        self._next = 0
        self._tracer = tracer

    def stage(self, t0: int, t1: int) -> Dict[str, torch.Tensor]:
        """Stacked round batches [R, ...] for rounds [t0, t1) on the
        device."""
        with self._tracer.span("batch_stage", t0=t0, t1=t1):
            return self._stage(t0, t1)

    def _stage(self, t0: int, t1: int) -> Dict[str, torch.Tensor]:
        i = self._next
        self._next = (self._next + 1) % len(self._slots)
        per_round = [self._pipeline.batch(int(t)) for t in range(t0, t1)]
        like = {}
        for key, first in per_round[0].items():
            if key == "labels":
                continue
            dtype = np.asarray(first).dtype
            like[key] = ((len(per_round),) + np.shape(first),
                         np.int64 if dtype == np.int32 else dtype)
        block = self._slots[i]
        if block is not None:
            block.wait()                        # host buffer reusable
        if block is None or block.signature != _signature(like):
            block = self._slots[i] = HostBlock(like, self._device)
        for r, b in enumerate(per_round):
            for key, view in block.host.items():
                view[r] = b[key]
        return block.ship()


def stack_batches(pipeline, t0: int, t1: int, device) -> Dict[str,
                                                               torch.Tensor]:
    """Round batches [R, K, b, S] for rounds [t0, t1) on `device` (labels
    dropped, token ids as int64) — one-shot, no buffer reuse."""
    return BatchStager(pipeline, device, slots=1).stage(t0, t1)


# ---------------------------------------------------------------------------
# Chunk prefetch (host-side prep of chunk i+1 overlaps device compute of i)
# ---------------------------------------------------------------------------

class ChunkPrefetcher:
    """One-chunk-ahead host pipeline with the reference's handshake.

    `prepare(a, b)` does the host work for chunk [a, b): the control trace
    and the batch staging, each ending in one non-blocking copy. Chunks are
    prepared in round order on one worker thread. The driver calls
    `kick(i + 1)` only AFTER it has synced chunk i-1's metrics: chunk i-1
    has then finished, so the stager slot it shares with chunk i+1 can be
    rewritten.

    `get(i)` waits for the kicked preparation (or runs it inline when
    nothing was kicked: chunk 0, or `overlap=False`); the wait accumulates
    in `stall_s`. A kicked preparation that failed on the worker is re-run
    inline once (counted in `degraded`); a second failure propagates. The
    re-run is deterministic: chunks are prepared in round order, and an
    injected fault (`injector`, site "chunk_prep") fires at the
    preparation's entry, before the stateful FaultModel RNG is drawn.

    Telemetry (`tracer`): each preparation runs in a ``chunk_prep`` span
    (on the worker thread when kicked, `kicked` in its args), every kick
    drops a ``prefetch_kick`` instant, an inline re-run runs in a
    ``prefetch_degraded`` span, and each `get` records a ``prep_stall``
    span from the same perf_counter endpoints that `stall_s` adds, so the
    spans' sum is `stall_s`."""

    def __init__(self, prepare: Callable[[int, int], Any],
                 bounds: Sequence[Tuple[int, int]], overlap: bool = True,
                 injector=None, tracer: ob.Tracer = ob.NULL_TRACER):
        self._prepare = prepare
        self._bounds = list(bounds)
        self._overlap = overlap and len(self._bounds) > 0
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="chunk-prefetch") \
            if self._overlap else None
        self._fut: Optional[Future] = None
        self._fut_i = -1
        self._next = 0            # next chunk index the driver may get()
        self.stall_s = 0.0
        self.degraded = 0         # kicked preparations re-run inline
        self._injector = injector
        self._tracer = tracer

    def _run_prepare(self, i: int, kicked: bool) -> Any:
        a, b = self._bounds[i]
        with self._tracer.span("chunk_prep", chunk=i, t0=a, t1=b,
                               kicked=kicked):
            if self._injector is not None:
                self._injector.fire("chunk_prep")
            return self._prepare(a, b)

    def kick(self, i: int) -> None:
        """Start chunk i's preparation on the worker thread (no-op when
        overlap is off, i is out of range, or i was already kicked or
        consumed)."""
        if (self._overlap and self._fut is None and i == self._next
                and i < len(self._bounds)):
            self._fut_i = i
            self._tracer.instant("prefetch_kick", chunk=i)
            self._fut = self._pool.submit(self._run_prepare, i, True)

    def get(self, i: int) -> Any:
        """The prepared payload for chunk i (blocks; stall time recorded)."""
        if i != self._next:
            raise ValueError(f"chunk {i} requested, chunk {self._next} is "
                             "next: chunks are consumed in order")
        self._next += 1
        t0 = time.perf_counter()
        if self._fut is not None:
            fut, self._fut = self._fut, None
            try:
                out = fut.result()
            except Exception as exc:  # noqa: BLE001 - re-run once, inline
                self.degraded += 1
                with self._tracer.span("prefetch_degraded", chunk=i,
                                       error=type(exc).__name__):
                    out = self._run_prepare(i, False)
        else:
            out = self._run_prepare(i, False)
        t1 = time.perf_counter()
        self.stall_s += t1 - t0
        self._tracer.add_span("prep_stall", t0, t1, chunk=i)
        return out

    def close(self) -> None:
        if self._pool is not None:
            if self._fut is not None:          # drain an abandoned prep
                try:
                    self._fut.result()
                except Exception:  # noqa: BLE001 - its chunk never runs
                    pass
                self._fut = None
            self._pool.shutdown(wait=True)
            self._pool = None


# ---------------------------------------------------------------------------
# Executors: per-round dispatch (loop) and a replayed CUDA graph (scan)
# ---------------------------------------------------------------------------

def _row(stack: Dict, r: int) -> Dict:
    return {k: v[r] for k, v in stack.items()}


def _run_eager(step: Callable, params: Params, ctl_stack: Dict,
               batch_stack: Dict[str, torch.Tensor], rounds: range,
               probe=None) -> Tuple[Params, Dict[str, List[torch.Tensor]]]:
    collected: Dict[str, list] = {}
    for r in rounds:
        # `probe` (a context manager, e.g. `obs.cost.RoundCost`) wraps the
        # first round only
        with probe if probe is not None and r == rounds.start \
                else contextlib.nullcontext():
            params, metrics = step(params, _row(batch_stack, r),
                                   _row(ctl_stack, r))
        for k, v in metrics.items():
            collected.setdefault(k, []).append(v)   # no per-round sync
    return params, collected


class LoopExecutor:
    """Per-round dispatch of the round body over a stacked trace.
    `run(..., probe=)` wraps the chunk's first round in the context manager
    `probe` (the run's cost counting, `obs.cost.RoundCost`)."""

    def __init__(self, step: Callable):
        self._step = step

    def run(self, params: Params, ctl_stack: Dict,
            batch_stack: Dict[str, torch.Tensor], probe=None
            ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        rounds = len(ctl_stack["seed"])
        params, collected = _run_eager(self._step, params, ctl_stack,
                                       batch_stack, range(rounds), probe)
        return params, {k: torch.stack(v) for k, v in collected.items()}


class _Graph:
    """One round of the step captured as a CUDA graph: static input
    buffers (one control row, one batch row), the metrics it writes, and
    the kernel launches its capture recorded."""

    def __init__(self, step: Callable, params: Params, ctl: Dict,
                 batch: Dict[str, torch.Tensor]):
        self.ctl = {k: v.clone() for k, v in ctl.items()}
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.graph = torch.cuda.CUDAGraph()
        before = kops.read_launches()
        # capture records the launches and runs none of them: the params
        # do not move, and the wrappers' counts are handed back below
        with torch.cuda.graph(self.graph):
            _, self.metrics = step(params, self.batch, self.ctl)
        retrace.bump(retrace.CHUNK_TRACE)
        after = kops.read_launches()
        self.launches = {k: after[k] - before[k] for k in after}
        kops.add_launches({k: -n for k, n in self.launches.items()})

    def replay(self, ctl: Dict, batch: Dict[str, torch.Tensor]) -> None:
        global replays
        for static, row in ((self.ctl, ctl), (self.batch, batch)):
            for k, buf in static.items():
                buf.copy_(row[k])
        self.graph.replay()
        kops.add_launches(self.launches)
        replays += 1


def _graph_key(params: Params, ctl: Dict, batch: Dict) -> tuple:
    # the graph bakes in every address it reads and writes: the leaves'
    # (updated in place) and its own static buffers, shaped like these
    # rows; and the kernels or plain versions the capture recorded
    return (kops.current_impl(),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype) for _, t in
                  zo.flatten(params)),
            tuple((k, tuple(v.shape), v.dtype) for k, v in ctl.items()),
            tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()))


class ScanExecutor:
    """A chunk of rounds with one dispatch per round from a captured CUDA
    graph: the counterpart of the reference's `lax.scan` over the step
    (PyTorch has no `jit` to compile a chunk into one program).

    The step's carry (`params` below) is the parameter tree, or the FO
    step's (params, optimizer state) pair; either is updated in place.

    On the card `run` runs the chunk's first round eagerly, through the same
    round body as the loop (that round makes every first use: cuBLAS
    handles, the kernel libraries' load and their shared-memory
    attributes, `zo._const`'s device scalars, the autograd engine's device
    thread under FO). When no graph for these leaves and row shapes is
    cached, that round is the capture's warm-up and runs on a side stream
    (PyTorch's whole-network capture recipe), and one round is then
    captured into a
    `torch.cuda.CUDAGraph` whose static inputs hold one control row (leaf
    seeds included) and one batch row; under FO the capture holds the
    whole round, forward, backward (`torch.autograd.grad`) and the
    optimizer's in-place update. For each remaining round it copies
    row r into those inputs, replays the graph and copies the metrics out:
    no host sync inside a chunk. The graph is kept for the next chunk and
    the next run of the same step while the leaves it updates in place stay
    where they are. A failure to capture or replay raises; nothing falls
    back to eager rounds on the card.

    On the CPU there is no graph: the rounds run eagerly one after the
    other, with no per-round sync, exactly as `LoopExecutor` runs them.

    `run(..., probe=)` wraps the chunk's first round, which always runs
    eagerly, in the context manager `probe` (the run's cost counting);
    a capture is never counted."""

    def __init__(self, step: Callable):
        self._step = step
        self._graph: Optional[Tuple[tuple, _Graph]] = None

    def run(self, params: Params, ctl_stack: Dict,
            batch_stack: Dict[str, torch.Tensor], probe=None
            ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        rounds = len(ctl_stack["seed"])
        dev_ctl = {k: v for k, v in ctl_stack.items()
                   if isinstance(v, torch.Tensor)}
        on_card = dev_ctl["c"].device.type == "cuda"
        if not on_card:
            params, collected = _run_eager(self._step, params, ctl_stack,
                                           batch_stack, range(rounds), probe)
            return params, {k: torch.stack(v) for k, v in collected.items()}
        row0 = (_row(dev_ctl, 0), _row(batch_stack, 0))
        key = _graph_key(params, *row0)    # the eager round moves no leaf
        if rounds > 1 and (self._graph is None or self._graph[0] != key):
            # the round before a capture is its warm-up, on a side stream
            # (PyTorch's whole-network capture recipe)
            main = torch.cuda.current_stream()
            side = _warmup_stream(main.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                params, collected = _run_eager(self._step, params, ctl_stack,
                                               batch_stack, range(1), probe)
            main.wait_stream(side)
            self._graph = None                 # free the old graph's pool
            self._graph = (key, _Graph(self._step, params, *row0))
        else:
            params, collected = _run_eager(self._step, params, ctl_stack,
                                           batch_stack, range(1), probe)
        if rounds == 1:
            return params, {k: torch.stack(v) for k, v in collected.items()}
        out = {k: torch.empty((rounds,) + v[0].shape, dtype=v[0].dtype,
                              device=v[0].device)
               for k, v in collected.items()}
        for k, v in collected.items():
            out[k][0].copy_(v[0])
        graph = self._graph[1]
        for r in range(1, rounds):
            graph.replay(_row(dev_ctl, r), _row(batch_stack, r))
            for k, v in graph.metrics.items():
                out[k][r].copy_(v)
        return params, out



@functools.lru_cache(maxsize=None)
def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream every executor's warm-up round runs on: cuBLAS
    keeps a 32 MiB workspace for each stream it runs on, for the life of
    the process."""
    return torch.cuda.Stream(device)


@functools.lru_cache(maxsize=8)
def get_executor(step: Callable) -> ScanExecutor:
    """Executor cache keyed on the step (memoized by `pairzero.make_zo_step`
    and `make_fo_step`), so identical runs share one captured graph;
    `get_executor.cache_clear()` releases the graphs and their memory
    pools. A miss counts as a `scan_executor_build` (`obs.retrace`)."""
    retrace.bump(retrace.SCAN_EXEC_BUILD)
    return ScanExecutor(step)


@functools.lru_cache(maxsize=64)
def get_loop_executor(step: Callable) -> LoopExecutor:
    """Executor cache keyed on the step, as the reference's is; a miss
    counts as a `loop_executor_build` (`obs.retrace`)."""
    retrace.bump(retrace.LOOP_EXEC_BUILD)
    return LoopExecutor(step)


def chunk_boundaries(start: int, stop: int, chunk_rounds: int,
                     align: Tuple[int, ...] = ()) -> list:
    """Split [start, stop) into chunks of ≤ chunk_rounds, also cutting at
    every multiple of each period in `align` (hook cadences)."""
    periods = [p for p in align if p and p > 0]
    bounds = []
    t = start
    while t < stop:
        nxt = min(t + max(1, chunk_rounds), stop)
        for p in periods:
            m = ((t // p) + 1) * p
            if t < m < nxt:
                nxt = m
        bounds.append((t, nxt))
        t = nxt
    return bounds
