"""Observability (`repro_torch.obs`) against `repro.obs`, and its hooks in
the driver, the checkpointer, the injector and the training CLI.

Tolerances:
- the tracer, the health monitor, `read_ledger` and the retrace counters
  (pure host Python in both packages): equal;
- the set of span, instant and counter names of one run (scan, chunk 3, a
  `CheckpointHook`, an armed injector): equal to `repro`'s;
- the trilemma ledger of a 4-round tiny run under desync, a client fault
  mask and robust_decode (from the same weights): the header and the
  accounting columns (`round`, `k_eff`, `k_sync`, `stale_frac`,
  `bits_round`, `bits_cum`, `dp_cost`, `dp_spent_cum`, `eps_cum`; host
  numpy in both) bitwise; `loss` rtol 1e-4, as `test_torch_engine.py`
  holds trajectories against `repro`;
- the synthetic abort (round 4, scan, chunk 2, 12 planned rounds): steps,
  privacy_spent and privacy_spent_per_round bitwise `repro`'s. `repro`'s
  own abort save fails: its executors donate the carry, so the boundary
  weights it hands the saver are deleted (`ckpt_snapshot_failed` 1, no
  file). The port's checkpoint is held against what that save would have
  written: the step and round of `repro`'s last boundary and its
  accountant's state bitwise, and `repro`'s weights after those rounds
  within the trajectory tolerance carried to the weights: each round moves
  a weight by lr·p̂·z, p̂ within the trajectory tests' rtol 1e-4 / atol
  1e-4 and |z| ≤ 5.8 (the largest Box–Muller draw from 24-bit uniforms),
  so the weights may part by lr·Σ_t 1e-4·(1 + |p̂_t|)·5.8, plus 4 f32 ulps
  of max|w|;
- port-only: telemetry and every hook on ≡ off bitwise (losses, p̂, the
  spend, the final weights) on both engines; the last ledger row equals
  `RunResult` exactly; compile_stats cold 1 / warm 0; `live_buffer_bytes`
  counts a shared storage once; `cost_stats["flops"]` equals
  `FlopCounterMode` over the same round body run directly, and a matmul
  counts 2·M·N·K; the profiler merge and the CLI's artifacts pass
  `tools/check_trace.py` (run as a subprocess, unchanged).
"""
import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import inject as jinj  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim, pairzero, zo  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs.memory import live_buffer_bytes  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime import inject as inj  # noqa: E402
from test_torch_round import configs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CHECK_TRACE = str(REPO / "tools" / "check_trace.py")
ACCOUNTING = ("round", "k_eff", "k_sync", "stale_frac", "bits_round",
              "bits_cum", "dp_cost", "dp_spent_cum", "eps_cum")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny runs are thousands of small ops: one intra-op thread
    runs them faster than a pool sharing the machine with the other test
    workers. The thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipes():
    return (FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4,
                              seed=0),
            JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0))


def _jparams(jcfg):
    return jreg.init_params(jax.random.key(0), jcfg)


def _params(jparams):
    """A fresh copy of `repro`'s weights for the port (its runs update
    their params in place)."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _run(pz, rounds=6, **kw):
    cfg = configs(base, n_perturb=1)[0]
    params = _params(_jparams(configs(jbase, n_perturb=1)[0]))
    return fedsim.run(cfg, pz, _pipes()[0], rounds, params=params,
                      device="cpu", **kw)


def _check_trace(*args):
    return subprocess.run([sys.executable, CHECK_TRACE, *map(str, args)],
                          capture_output=True, text=True, cwd=REPO)


def _same_weights(a, b):
    for (path, x), (_, y) in zip(zo.flatten(a), zo.flatten(b), strict=True):
        assert torch.equal(x, y), path


# ---------------------------------------------------------------------------
# Tracer, retrace, health: pure host code in both packages
# ---------------------------------------------------------------------------

def _trace_calls(tr):
    with tr.span("outer", which=1):
        with tr.span("inner"):
            pass
    t0 = time.perf_counter()
    tr.add_span("measured", t0, t0 + 0.25, chunk=7)
    tr.instant("mark", chunk=7)
    tr.counter("bytes", 123.0)


def test_tracer_nesting_exactness_and_export_match_reference(tmp_path):
    out = {}
    for name, mod in (("port", obs), ("ref", jobs)):
        tr = mod.Tracer()
        _trace_calls(tr)
        spans = tr.spans()
        assert [s["name"] for s in spans] == ["inner", "outer", "measured"]
        inner, outer, measured = spans
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert measured["dur"] == pytest.approx(0.25, abs=1e-12)
        assert tr.total_s("measured") == measured["dur"]
        path = tmp_path / f"{name}.json"
        tr.export_chrome(str(path), metadata={"prep_stall_s": 0.0},
                         extra_events=[{"name": "k", "ph": "X", "pid": 7,
                                        "tid": 1, "ts": 1.0, "dur": 2.0}])
        doc = json.loads(path.read_text())
        out[name] = [{k: v for k, v in e.items()
                      if k not in ("ts", "dur", "tid")}
                     for e in doc["traceEvents"]]
        assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
        assert doc["otherData"] == {"prep_stall_s": 0.0}
    for e in out["port"] + out["ref"]:
        if e["ph"] == "M":
            e["args"] = {}            # the thread's name
    assert out["port"] == out["ref"]


def test_null_tracer_is_inert(tmp_path):
    nt = obs.NULL_TRACER
    assert not nt.enabled and nt.epoch == 0.0
    with nt.span("anything", x=1):
        nt.add_span("a", 0.0, 1.0)
        nt.instant("b")
        nt.counter("c", 1.0)
    assert nt.events() == [] and nt.spans() == []
    out = tmp_path / "never.json"
    nt.export_chrome(str(out))
    assert not out.exists()
    assert obs.Telemetry.off().enabled is False
    assert obs.Telemetry.on().enabled is True
    assert obs.Telemetry(cost=True).enabled is True


def test_retrace_since_keeps_zero_entries_and_suspends():
    assert obs.retrace.CANONICAL == jobs.retrace.CANONICAL
    before = obs.retrace.snapshot()
    obs.retrace.bump(obs.retrace.ZO_STEP_BUILD)
    with obs.retrace.suspended():
        obs.retrace.bump(obs.retrace.FO_STEP_BUILD)
    delta = obs.retrace.since(before)
    assert delta[obs.retrace.ZO_STEP_BUILD] == 1
    assert delta[obs.retrace.FO_STEP_BUILD] == 0
    assert set(obs.retrace.CANONICAL) <= set(delta)


LOSSES = [1.0, 50.0, 60.0, 0.5, 0.6, 0.7, 0.8, float("nan"), 0.4, 0.4,
          0.4, 9.0, float("inf"), 0.3]


@pytest.mark.parametrize("kw", [
    dict(divergence_factor=10.0, plateau_rounds=2),
    dict(divergence_factor=0.0, plateau_rounds=3, plateau_tol=0.05),
    dict(divergence_factor=5.0)])
def test_health_monitor_events_match_reference(kw):
    ours = obs.HealthMonitor("warn", **kw)
    ref = jobs.HealthMonitor("warn", **kw)
    for hm in (ours, ref):
        hm.on_start(None)
        for t, loss in enumerate(LOSSES):
            hm.on_round(t, {"loss": loss})
    assert [e["kind"] for e in ours.events] == \
        [e["kind"] for e in ref.events]
    assert [e["round"] for e in ours.events] == \
        [e["round"] for e in ref.events]
    np.testing.assert_array_equal([e["loss"] for e in ours.events],
                                  [e["loss"] for e in ref.events])
    raised = []
    for mod in (obs, jobs):
        hm = mod.HealthMonitor("abort", **kw)
        hm.on_start(None)
        with pytest.raises(mod.HealthAbort) as info:
            for t, loss in enumerate(LOSSES):
                hm.on_round(t, {"loss": loss})
        raised.append((info.value.round, info.value.reason))
    assert raised[0] == raised[1]
    with pytest.raises(ValueError):
        obs.HealthMonitor(policy="explode")


def _write_ledger(path, n_rows, torn_at=None):
    lines = [json.dumps({"schema": obs.MetricsSink.SCHEMA, "arch": "tiny"})]
    lines += [json.dumps({"round": i, "loss": 1.0}) for i in range(n_rows)]
    if torn_at is not None:
        lines[torn_at] = lines[torn_at][: len(lines[torn_at]) // 2]
    path.write_text("\n".join(lines) + "\n")


def test_read_ledger_tolerates_a_torn_tail_only(tmp_path):
    p = tmp_path / "m.jsonl"
    _write_ledger(p, 4, torn_at=4)           # the last row torn
    with pytest.raises(json.JSONDecodeError):
        obs.read_ledger(str(p))              # strict by default
    for mod in (obs, jobs):
        led = mod.read_ledger(str(p), strict=False)
        assert led["truncated"] is True and len(led["rows"]) == 3
    _write_ledger(p, 4, torn_at=2)           # a torn middle line
    with pytest.raises(json.JSONDecodeError):
        obs.read_ledger(str(p), strict=False)
    _write_ledger(p, 4)
    led = obs.read_ledger(str(p), strict=False)
    assert led["truncated"] is False and len(led["rows"]) == 4
    assert obs.final_row(str(p)) == {"round": 3, "loss": 1.0}


def test_live_buffer_bytes_counts_a_shared_storage_once():
    a = torch.ones(128)
    b = torch.ones(16, 16)
    views = [b, b[3:], b.reshape(256), b[None], b.t()]
    assert live_buffer_bytes([a] + views) == 128 * 4 + 256 * 4
    assert live_buffer_bytes([a, a.clone()]) == 2 * 128 * 4
    assert live_buffer_bytes([a], device="cuda") == 0
    # the collector's walk sees at least these two
    assert live_buffer_bytes(device="cpu") >= 128 * 4 + 256 * 4
    assert obs.memory.device_peak_bytes("cpu") is None


def test_round_cost_counts_a_matmul_as_2mnk():
    m, k, n = 6, 7, 5
    x, w = torch.randn(m, k), torch.randn(k, n)
    with obs.cost.RoundCost() as rc:
        y = torch.mm(x, w)
        y.view(-1)                             # a view moves no bytes
    stats = rc.stats()
    assert stats.flops == 2 * m * n * k
    assert stats.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert stats.kernel_flops == 0 and stats.peak_bytes == 0
    assert "collectives      none" in obs.cost.describe(stats)
    assert torch.equal(y, x @ w)


# ---------------------------------------------------------------------------
# The driver: passivity, names, ledger, abort, compile stats, cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine_name", ["loop", "scan"])
def test_telemetry_and_every_hook_are_passive(tmp_path, engine_name):
    """Telemetry on (spans, memory every 2 rounds, the first round's cost),
    a MetricsSink, a HealthMonitor (warn), a CheckpointHook and the
    profiler against a plain run: bitwise the same run."""
    _, pz = configs(base, n_perturb=1)
    kw = dict(engine=engine_name, chunk_rounds=3)
    plain = _run(pz, **kw)
    sink = obs.MetricsSink(str(tmp_path / "m.jsonl"))
    health = obs.HealthMonitor("warn")
    prof = obs.ProfilerSession(logdir=str(tmp_path / "prof"))
    prof.start()
    res = _run(pz, telemetry=obs.Telemetry.on(memory_sample_every=2,
                                              cost=True),
               hooks=[sink, health], checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=3, **kw)
    prof.stop()
    assert res.losses == plain.losses and res.p_hats == plain.p_hats
    assert res.privacy_spent == plain.privacy_spent
    assert res.uplink_bits == plain.uplink_bits
    _same_weights(res.params, plain.params)
    assert res.peak_bytes > 0 and sink.rows_written() == 6
    assert res.cost_stats["flops"] > 0 and res.health_abort_round == -1
    assert plain.peak_bytes == 0 and plain.cost_stats is None
    assert ckpt.latest_valid(str(tmp_path / "ck")).endswith("step_00000006")


def _armed(mod, tracer):
    return mod.FaultInjector.from_specs(
        ["chunk_prep:exception:@1", "dispatch:exception:@1",
         "ckpt_write:torn_write:@0"], tracer=tracer)


def _names(tracer):
    return {(e["ph"], e["name"]) for e in tracer.events()}


def test_span_and_instant_names_match_reference(tmp_path):
    """One run of each package (scan, chunk 3, checkpoints every 3 with the
    first write torn, a chunk preparation and a dispatch failing once):
    the same span, instant and counter names; the stall spans sum to the
    stall scalars exactly; the kick of chunk i fires inside chunk i−1."""
    cfg, pz = configs(base, n_perturb=1)
    jcfg, jpz = configs(jbase, n_perturb=1)
    jtel = jobs.Telemetry.on(memory_sample_every=2)
    jfedsim.run(jcfg, jpz, _pipes()[1], rounds=6, engine="scan",
                chunk_rounds=3, checkpoint_dir=str(tmp_path / "ref"),
                checkpoint_every=3, telemetry=jtel,
                injector=_armed(jinj, jtel.tracer), params=_jparams(jcfg),
                dtype=jnp.float32)
    tel = obs.Telemetry.on(memory_sample_every=2)
    res = _run(pz, engine="scan", chunk_rounds=3,
               checkpoint_dir=str(tmp_path / "port"), checkpoint_every=3,
               telemetry=tel, injector=_armed(inj, tel.tracer))
    assert _names(tel.tracer) == _names(jtel.tracer)
    assert {"retry", "prefetch_degraded", "ckpt_write"} <= {
        n for ph, n in _names(tel.tracer) if ph == "X"}
    assert {"inject", "ckpt_torn", "prefetch_kick"} <= {
        n for ph, n in _names(tel.tracer) if ph == "i"}
    tr = tel.tracer
    assert tr.total_s("prep_stall") == pytest.approx(res.prep_stall_s,
                                                     abs=1e-12)
    assert tr.total_s("ckpt_snapshot") == pytest.approx(res.ckpt_stall_s,
                                                        abs=1e-12)
    chunks = {s["args"]["chunk"]: s for s in tr.spans("chunk")}
    kicks = {e["args"]["chunk"]: e["ts"] for e in tr.events()
             if e["name"] == "prefetch_kick"}
    assert kicks and sorted(chunks) == [0, 1]
    for i, ts in kicks.items():
        prev = chunks[i - 1]
        assert prev["ts"] <= ts <= prev["ts"] + prev["dur"]


def test_ledger_matches_reference_under_desync_faults_and_defense(tmp_path):
    bz = dict(behavior="sign_flip", fraction=0.4, defense="robust_decode",
              groups=2)
    ds = dict(fraction=0.5, max_lag=2, phase_std=0.3, seed=0)
    cfg, pz = configs(base, n_perturb=1)
    jcfg, jpz = configs(jbase, n_perturb=1)
    pz = dataclasses.replace(pz, byzantine=base.ByzantineConfig(**bz),
                             desync=base.DesyncConfig(**ds))
    jpz = dataclasses.replace(jpz, byzantine=jbase.ByzantineConfig(**bz),
                              desync=jbase.DesyncConfig(**ds))
    jpath, path = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jfedsim.run(jcfg, jpz, _pipes()[1], rounds=4, engine="loop",
                params=_jparams(jcfg), dtype=jnp.float32,
                fault=jfault.FaultModel(5, dropout_p=0.3, seed=1),
                telemetry=jobs.Telemetry.on(),
                hooks=[jobs.MetricsSink(str(jpath))])
    res = _run(pz, rounds=4, fault=fault.FaultModel(5, dropout_p=0.3,
                                                    seed=1),
               telemetry=obs.Telemetry.on(),
               hooks=[obs.MetricsSink(str(path))])
    ref, ours = obs.read_ledger(str(jpath)), obs.read_ledger(str(path))
    assert ours["header"] == ref["header"]
    assert len(ours["rows"]) == len(ref["rows"]) == 4
    for a, b in zip(ours["rows"], ref["rows"]):
        for key in ACCOUNTING:
            assert a[key] == b[key], (a["round"], key)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    rows = ours["rows"]
    # the scenario is live: a client masked out, a stale one, a defense
    assert min(r["k_eff"] for r in rows) < 5
    assert any(r["k_sync"] < r["k_eff"] for r in rows)
    assert [r["loss"] for r in rows] == res.losses


def test_sink_lets_go_of_the_run(tmp_path):
    """The run holds its hooks; a sink that kept holding the run after
    `close` would be a reference cycle keeping the weights alive until the
    garbage collector runs (on the card: a θ on every later run's peak)."""
    cfg, pz = configs(base, n_perturb=1)
    sink = obs.MetricsSink(str(tmp_path / "m.jsonl"))
    exp = fedsim.Experiment(cfg, pz, _pipes()[0], 2, hooks=[sink],
                            telemetry=obs.Telemetry.on(), device="cpu")
    res = exp.run()
    run, leaf = weakref.ref(exp), weakref.ref(zo.flatten(res.params)[0][1])
    gc.disable()
    try:
        del exp, res
        assert run() is None and leaf() is None
    finally:
        gc.enable()
    assert sink.rows_written() == 2


def test_last_ledger_row_equals_run_result(tmp_path):
    _, pz = configs(base, n_perturb=1)
    path = str(tmp_path / "m.jsonl")
    res = _run(pz, rounds=7, engine="scan", chunk_rounds=3,
               telemetry=obs.Telemetry.on(memory_sample_every=2),
               hooks=[obs.MetricsSink(path)])
    rows = obs.read_ledger(path)["rows"]
    final = rows[-1]
    assert len(rows) == res.steps == 7
    assert final["bits_cum"] == res.uplink_bits
    assert final["dp_spent_cum"] == res.privacy_spent
    assert final["peak_bytes"] == res.peak_bytes > 0
    assert [r["dp_spent_cum"] for r in rows] == \
        list(res.privacy_spent_per_round)
    assert sum(r["bits_round"] for r in rows) == final["bits_cum"]
    per_round = tp.resolve(pz).bits_per_round(pz, configs(base)[0]
                                              .param_count())
    assert all(r["bits_round"] == per_round for r in rows)


class _FireAt:
    """Raise a synthetic HealthAbort at the first round >= `t` (on a
    HealthMonitor of the abort policy, so the driver keeps the boundary
    weights)."""

    def __init__(self, mod, t):
        self.hm = mod.HealthMonitor("abort")
        self.fired = False

        def fire(r, metrics):
            if r >= t and not self.fired:
                self.fired = True
                raise mod.HealthAbort(r, "synthetic")
        self.hm.on_round = fire


def test_synthetic_abort_matches_reference(tmp_path):
    cfg, pz = configs(base, n_perturb=1)
    jcfg, jpz = configs(jbase, n_perturb=1)
    pz = dataclasses.replace(pz, rounds=12)
    jpz = dataclasses.replace(jpz, rounds=12)
    kw = dict(rounds=12, engine="scan", chunk_rounds=2, checkpoint_every=4)
    # repro's executors donate the weights they are given: each of its
    # runs takes a fresh init
    jexp = jfedsim.Experiment(
        jcfg, jpz, _pipes()[1], 12, engine="scan", chunk_rounds=2,
        hooks=[_FireAt(jobs, 4).hm,
               jfedsim.CheckpointHook(str(tmp_path / "ref"), 4)],
        params=_jparams(jcfg), dtype=jnp.float32)
    ref = jexp.run()
    res = _run(pz, hooks=[_FireAt(obs, 4).hm],
               checkpoint_dir=str(tmp_path / "port"), **kw)
    assert res.health_abort_round == ref.health_abort_round == 4
    assert res.health_abort_reason == ref.health_abort_reason == "synthetic"
    assert res.steps == ref.steps == 8
    assert res.privacy_spent == ref.privacy_spent
    np.testing.assert_array_equal(res.privacy_spent_per_round,
                                  ref.privacy_spent_per_round)
    # repro's own abort save failed on its donated buffers
    assert ref.retry_attempts == {"ckpt_snapshot_failed": 1}
    assert res.retry_attempts == {}
    path = ckpt.latest_valid(str(tmp_path / "port"))
    assert path.endswith("step_00000006")      # the last boundary
    like = _params(_jparams(jcfg))
    weights, step, extra = ckpt.restore(path, like)
    assert step == extra["round"] == 6
    assert extra["accountant"] == jexp.accountant.state_dict()
    # repro's weights at that boundary: its run of the same 6 rounds
    at6 = jfedsim.run(jcfg, jpz, _pipes()[1], rounds=6, engine="scan",
                      chunk_rounds=2, params=_jparams(jcfg),
                      dtype=jnp.float32)
    drift = pz.zo.lr * sum(1e-4 * (1 + abs(p)) for p in at6.p_hats) * 5.8
    for (p, got), want in zip(zo.flatten(weights),
                              jax.tree_util.tree_leaves(at6.params),
                              strict=True):
        want = np.asarray(want)
        ulps = 4 * np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=drift + ulps, err_msg=p)
    # and the weights after round 7 moved on from them in place
    assert not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(zo.flatten(weights), zo.flatten(res.params)))


def test_compile_stats_cold_then_warm():
    """A config no other test builds: the cold scan run builds one step
    and one executor, its warm rerun on the same parameters nothing; then
    the loop engine builds its executor once. No capture on the CPU."""
    cfg, pz = configs(base, n_perturb=1)
    pz = dataclasses.replace(pz, zo=dataclasses.replace(pz.zo,
                                                        mu=1.2345e-3))
    params = _params(_jparams(configs(jbase, n_perturb=1)[0]))
    pipe = _pipes()[0]
    runs = [fedsim.run(cfg, pz, pipe, 4, params=params, device="cpu", **kw)
            for kw in (dict(engine="scan", chunk_rounds=2),
                       dict(engine="scan", chunk_rounds=2),
                       dict(engine="loop"), dict(engine="loop"))]
    cold, warm, loop_cold, loop_warm = (r.compile_stats for r in runs)
    assert cold == {**dict.fromkeys(obs.retrace.CANONICAL, 0),
                    "zo_step_build": 1, "scan_executor_build": 1}
    assert all(v == 0 for v in warm.values()), warm
    assert loop_cold == {**dict.fromkeys(obs.retrace.CANONICAL, 0),
                         "loop_executor_build": 1}
    assert all(v == 0 for v in loop_warm.values()), loop_warm


def test_cost_stats_equal_flop_counter_over_the_same_round():
    from torch.utils.flop_counter import FlopCounterMode
    cfg, pz = configs(base, n_perturb=2)
    jcfg = configs(jbase, n_perturb=2)[0]
    pipe = _pipes()[0]
    res = fedsim.run(cfg, pz, pipe, 2, params=_params(_jparams(jcfg)),
                     device="cpu", telemetry=obs.Telemetry(cost=True))
    sched = res.schedule
    trace = engine.build_trace(sched, pz, 0, 1, device="cpu",
                               n_leaves=len(zo.flatten(res.params)))
    batch = engine.stack_batches(pipe, 0, 1, "cpu")
    step = pairzero.make_zo_step(cfg, pz)
    with FlopCounterMode(display=False) as fc:
        step(_params(_jparams(jcfg)), {k: v[0] for k, v in batch.items()},
             {k: v[0] for k, v in trace.ctl.items()})
    assert res.cost_stats["flops"] == fc.get_total_flops() > 0
    assert res.cost_stats["bytes_accessed"] > 0
    assert res.cost_stats["kernel_flops"] == 0       # plain versions here
    assert res.cost_stats["collectives"] == {}


# ---------------------------------------------------------------------------
# Artifacts: the profiler merge and the CLI through tools/check_trace.py
# ---------------------------------------------------------------------------

def test_profiler_merge_passes_the_device_lane_gate(tmp_path):
    tracer = obs.Tracer()
    prof = obs.ProfilerSession(logdir=str(tmp_path / "prof"))
    prof.start()
    with tracer.span("chunk", chunk=0):
        with tracer.span("dispatch"):
            x = torch.ones((64, 64))
            (x @ x).sum()
        for name in ("chunk_prep", "prep_stall", "metrics_flush"):
            with tracer.span(name):
                pass
    prof.stop()
    events, meta = prof.device_events(tracer.epoch)
    assert meta["events"] > 0 and meta["anchor"] is True
    assert "error" not in meta
    assert all(e.get("pid") != 0 for e in events)
    merged = tmp_path / "merged.json"
    tracer.export_chrome(str(merged), metadata={"profile": meta},
                         extra_events=events)
    proc = _check_trace(merged, "--require-device-lane")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    host_only = tmp_path / "host.json"
    tracer.export_chrome(str(host_only))
    proc = _check_trace(host_only, "--require-device-lane")
    assert proc.returncode == 1 and "no device-lane" in proc.stdout


def _cli(argv):
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            summary, code = train.main(argv), 0
        except SystemExit as exit_:
            summary, code = None, exit_.code
    return summary, code, out.getvalue()


CLI = ["--device", "cpu", "--reduced", "--clients", "3", "--batch", "2",
       "--seq-len", "16", "--n-perturb", "1", "--eval-every", "0"]


def test_cli_artifacts_pass_check_trace(tmp_path):
    trace, ledger, out = (tmp_path / n for n in ("t.json", "m.jsonl",
                                                 "s.json"))
    summary, code, _ = _cli(CLI + [
        "--rounds", "6", "--engine", "scan", "--chunk-rounds", "3",
        "--trace-out", str(trace), "--metrics-out", str(ledger),
        "--out", str(out), "--health-policy", "warn"])
    assert code == 0 and summary["rounds"] == 6
    assert summary["peak_bytes"] > 0 and summary["cost_stats"]["flops"] > 0
    assert summary["health"] == {"policy": "warn", "events": [],
                                 "abort_round": -1, "abort_reason": ""}
    assert set(summary["compile_stats"]) == set(obs.retrace.CANONICAL)
    proc = _check_trace(trace, "--ledger", ledger, "--summary", out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "summary cross-checked" in proc.stdout
    doc = json.loads(trace.read_text())
    assert doc["otherData"]["engine"] == "scan"
    assert doc["otherData"]["cost_stats"] == summary["cost_stats"]


def test_cli_health_abort_exits_3_with_a_checkpoint(tmp_path):
    """An lr of 2 (400 times the CLI's) sends the loss past 10x its best
    after the first update (8357 from 6.3 at this config): the
    abort policy stops the run with status 3 and leaves a CRC-valid
    checkpoint at the last boundary before the abort surfaced."""
    directory = tmp_path / "ck"
    summary, code, text = _cli(CLI + [
        "--rounds", "12", "--engine", "scan", "--chunk-rounds", "2",
        "--lr", "2", "--health-policy", "abort",
        "--checkpoint-dir", str(directory), "--checkpoint-every", "4"])
    assert code == 3 and "HEALTH ABORT" in text
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    abort = summary["health"]["abort_round"]
    assert 0 <= abort < 12 and summary["rounds"] < 12
    path = ckpt.latest_valid(str(directory))
    assert path is not None and ckpt.valid_checkpoint(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    # the last boundary: the aborting round's chunk start, or (one chunk
    # late under scan) the chunk after it
    assert manifest["step"] in (abort - abort % 2, abort - abort % 2 + 2)
    assert manifest["step"] == manifest["extra"]["round"]
