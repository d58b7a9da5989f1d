"""Host fault injection of the port (`repro_torch.runtime.inject`, the
`chunk_prep` and `dispatch` sites of the run loop, the `ckpt_snapshot`
and `ckpt_write` sites of the checkpointer) against `repro`.

Tolerances: which invocations fire, bitwise (the same seeded draws); retry
counts equal; a run that recovers from injected faults equals the clean
run bitwise (losses, p̂, final weights), and reports the same recoveries
as `repro`'s run with the same specs.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.runtime import inject as jinj  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.runtime import inject as inj  # noqa: E402
from test_torch_round import configs  # noqa: E402


def _fires(injector, sites, n):
    """Each site's first n invocations, interleaved: the marker, or the
    exception's type name."""
    out = []
    for i in range(n):
        for site in sites:
            try:
                out.append(injector.fire(site))
            except (inj.InjectedFault, jinj.InjectedFault) as exc:
                out.append(type(exc).__name__)
    return out


def test_from_specs_parsing():
    injector = inj.FaultInjector.from_specs(
        ["dispatch:exception:@2,5", "ckpt_write:torn_write",
         "chunk_prep:delay:0.25"])
    assert injector.faults["dispatch"].at == (2, 5)
    assert injector.faults["ckpt_write"].p == 1.0
    assert injector.faults["chunk_prep"].p == 0.25
    assert inj.available_modes() == jinj.available_modes()
    assert inj.SITES == jinj.SITES


@pytest.mark.parametrize("spec,match", [
    (["dispatch"], "spec"), (["warp_core:exception"], "site"),
    (["dispatch:segfault"], "mode"), (["dispatch:exception:1.5"],
                                      "probability")])
def test_bad_specs_raise_as_the_reference(spec, match):
    with pytest.raises(ValueError, match=match) as ours:
        inj.FaultInjector.from_specs(spec)
    with pytest.raises(ValueError) as ref:
        jinj.FaultInjector.from_specs(spec)
    assert str(ours.value) == str(ref.value)


def test_exact_invocation_selector():
    injector = inj.FaultInjector.from_specs(["dispatch:exception:@1,3"])
    assert _fires(injector, ["dispatch"], 5) == [
        None, "InjectedFault", None, "InjectedFault", None]
    assert injector.fired == {"dispatch": 2}
    assert injector.counts == {"dispatch": 5}


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**40 + 3])
def test_firing_sets_equal_the_reference(seed):
    """Bernoulli selectors at every site and mode, interleaved: the same
    invocations fire in both packages."""
    specs = ["dispatch:exception:0.3", "chunk_prep:torn_write:0.5",
             "ckpt_write:torn_write:0.1", "ckpt_snapshot:exception:@0,4"]
    ours = inj.FaultInjector.from_specs(specs, seed=seed)
    ref = jinj.FaultInjector.from_specs(specs, seed=seed)
    sites = list(inj.SITES)
    a, b = _fires(ours, sites, 60), _fires(ref, sites, 60)
    assert a == b
    assert ours.fired == ref.fired and ours.counts == ref.counts
    assert 0 < ours.fired["dispatch"] < 60


def test_fires_depend_only_on_seed_site_and_invocation():
    a = inj.FaultInjector.from_specs(["dispatch:delay:0.3",
                                      "chunk_prep:delay:0.4"], seed=7)
    a.faults = {k: inj.SiteFault(v.mode, p=v.p, delay_s=0.0)
                for k, v in a.faults.items()}
    b = inj.FaultInjector.from_specs(["dispatch:torn_write:0.3"], seed=7)
    seq_a = [a.fire("dispatch") is not None for _ in range(50)]
    for _ in range(13):
        a.fire("chunk_prep")
    seq_b = [b.fire("dispatch") is not None for _ in range(50)]
    assert seq_a == seq_b and 0 < sum(seq_a) < 50


def test_unarmed_site_never_fires():
    injector = inj.FaultInjector.from_specs(["dispatch:exception"])
    assert injector.fire("ckpt_write") is None
    assert injector.counts["ckpt_write"] == 1 and injector.fired == {}
    assert injector.armed("dispatch") and not injector.armed("ckpt_write")


@pytest.mark.parametrize("specs,attempts", [
    (["dispatch:exception:@0"], 3), (["dispatch:exception:@0,1"], 3),
    (["dispatch:exception"], 3), (["dispatch:exception:@0"], 1),
    (["dispatch:exception:0.5"], 4)])
def test_with_retries_counts_equal_the_reference(specs, attempts):
    out = []
    for mod in (inj, jinj):
        injector = mod.FaultInjector.from_specs(specs, seed=3)
        retries, calls = {}, []
        try:
            got = mod.with_retries(lambda: calls.append(1) or "ok",
                                   site="dispatch", attempts=attempts,
                                   injector=injector, backoff_s=0.0,
                                   retries=retries)
        except (inj.InjectedFault, jinj.InjectedFault) as exc:
            got = type(exc).__name__
        out.append((got, retries, len(calls), injector.fired))
    assert out[0] == out[1]


def test_with_retries_plain_call_without_injector():
    assert inj.with_retries(lambda: 42, site="dispatch") == 42
    with pytest.raises(KeyError):
        inj.with_retries(lambda: {}["x"], site="dispatch", attempts=2,
                         backoff_s=0.0)


# ---------------------------------------------------------------------------
# ChunkPrefetcher: a preparation that died on the worker re-runs inline once
# ---------------------------------------------------------------------------

def test_prefetcher_degrades_to_an_inline_rerun():
    injector = inj.FaultInjector.from_specs(["chunk_prep:exception:@1"])
    prepared = []
    pf = engine.ChunkPrefetcher(
        lambda a, b: prepared.append((a, b, threading.current_thread()
                                      .name.startswith("chunk-prefetch")))
        or (a, b), [(0, 2), (2, 4), (4, 6)], overlap=True,
        injector=injector)
    out = []
    for i in range(3):
        pf.kick(i)
        out.append(pf.get(i))
    pf.close()
    assert out == [(0, 2), (2, 4), (4, 6)] and pf.degraded == 1
    # chunk 1 ran inline (invocation 2), the others on the worker
    assert prepared == [(0, 2, True), (2, 4, False), (4, 6, True)]


def test_prefetcher_second_failure_propagates():
    injector = inj.FaultInjector.from_specs(["chunk_prep:exception"])
    pf = engine.ChunkPrefetcher(lambda a, b: (a, b), [(0, 2)], overlap=True,
                                injector=injector)
    pf.kick(0)
    with pytest.raises(inj.InjectedFault):
        pf.get(0)
    pf.close()


# ---------------------------------------------------------------------------
# AsyncCheckpointer under injection
# ---------------------------------------------------------------------------

@pytest.fixture
def params():
    return {"w": torch.arange(8.0), "b": torch.ones(3)}


def test_ckpt_write_retry_then_success(tmp_path, params):
    injector = inj.FaultInjector.from_specs(["ckpt_write:exception:@0"])
    acp = ckpt.AsyncCheckpointer(str(tmp_path), injector=injector)
    acp.save(1, params, extra={})
    acp.wait()
    assert acp.write_failures == 0 and acp.retries == {"ckpt_write": 1}
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_00000001")


def test_ckpt_write_keeps_the_last_good(tmp_path, params):
    injector = inj.FaultInjector.from_specs(["ckpt_write:exception:@1,2"])
    acp = ckpt.AsyncCheckpointer(str(tmp_path), injector=injector,
                                 write_retries=2)
    acp.save(1, params, extra={})
    acp.wait()
    acp.save(2, params, extra={})
    acp.wait()
    assert acp.write_failures == 1
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_00000001")
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_ckpt_snapshot_failure_skips_the_boundary(tmp_path, params):
    injector = inj.FaultInjector.from_specs(["ckpt_snapshot:exception:@0"])
    acp = ckpt.AsyncCheckpointer(str(tmp_path), injector=injector)
    acp.save(1, params, extra={})
    acp.wait()
    acp.save(2, params, extra={})
    acp.wait()
    assert acp.snapshot_failures == 1
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]


def test_torn_write_detected_and_skipped(tmp_path, params):
    injector = inj.FaultInjector.from_specs(["ckpt_write:torn_write:@1"])
    acp = ckpt.AsyncCheckpointer(str(tmp_path), injector=injector)
    acp.save(1, params, extra={})
    acp.wait()
    acp.save(2, params, extra={})
    acp.wait()
    torn = ckpt.latest(str(tmp_path))
    assert torn.endswith("step_00000002")
    assert not ckpt.valid_checkpoint(torn)
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_00000001")


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def _pipe():
    return FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0)


@pytest.mark.parametrize("engine_name", ["loop", "scan"])
def test_injected_run_recovers_bitwise(engine_name):
    """A dispatch dies once and a prefetch worker dies once: the run
    retries and degrades, and lands on the clean run's trajectory."""
    cfg, pz = configs(base, n_perturb=1)
    kw = dict(device="cpu", engine=engine_name, chunk_rounds=2)
    clean = fedsim.run(cfg, pz, _pipe(), 6, **kw)
    assert clean.retry_attempts == {}
    injector = inj.FaultInjector.from_specs(
        ["dispatch:exception:@1", "chunk_prep:exception:@1"])
    res = fedsim.run(cfg, pz, _pipe(), 6, injector=injector, **kw)
    assert res.losses == clean.losses and res.p_hats == clean.p_hats
    assert res.retry_attempts == {"dispatch": 1, "prefetch_degraded": 1}
    for (path, x), (_, y) in zip(zo.flatten(res.params),
                                 zo.flatten(clean.params)):
        assert torch.equal(x, y), path


def test_unarmed_dispatch_fails_fast():
    """Without `dispatch` armed, a real dispatch failure is not retried:
    the params were already updated in place."""
    cfg, pz = configs(base, n_perturb=1)
    calls = []

    class Boom(engine.LoopExecutor):
        def run(self, *a):
            calls.append(1)
            raise RuntimeError("device fault")
    injector = inj.FaultInjector.from_specs(["chunk_prep:delay:@9"])
    exp = fedsim.Experiment(cfg, pz, _pipe(), 2, injector=injector,
                            device="cpu")
    real = engine.LoopExecutor
    engine.LoopExecutor = Boom
    # the executor cache would serve the step's cached real executor
    engine.get_loop_executor.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="device fault"):
            exp.run()
    finally:
        engine.LoopExecutor = real
        engine.get_loop_executor.cache_clear()
    assert calls == [1]


def test_recoveries_match_the_reference(tmp_path):
    """The same specs on each package's run (checkpoints every 2 rounds):
    the same recoveries reported, the same invocations fired."""
    specs = ["dispatch:exception:@2", "chunk_prep:exception:@1",
             "ckpt_write:exception:@1", "ckpt_snapshot:exception:@2"]
    cfg, pz = configs(base, n_perturb=1)
    jcfg, jpz = configs(jbase, n_perturb=1)
    jinjector = jinj.FaultInjector.from_specs(specs)
    ref = jfedsim.run(jcfg, jpz, JPipe("sst2", JSpec("sst2", 64, 24), 5, 4,
                                       seed=0), rounds=6, engine="loop",
                      checkpoint_dir=str(tmp_path / "ref"),
                      checkpoint_every=2, injector=jinjector,
                      dtype=jnp.float32)
    injector = inj.FaultInjector.from_specs(specs)
    res = fedsim.run(cfg, pz, _pipe(), 6, device="cpu",
                     checkpoint_dir=str(tmp_path / "port"),
                     checkpoint_every=2, injector=injector)
    assert res.retry_attempts == ref.retry_attempts
    assert res.retry_attempts == {"dispatch": 1, "prefetch_degraded": 1,
                                  "ckpt_write": 1, "ckpt_snapshot_failed": 1}
    assert injector.fired == jinjector.fired
    assert injector.counts == jinjector.counts
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
