"""Client faults and elastic membership of the port (`repro_torch.runtime.
fault` and the control trace's mask rows) against `repro`.

Tolerances: masks bitwise (host numpy, the same generator drawn in the
same order), validation errors of the same type and message; a faulted run
of each package from the same seed: masks bitwise, losses rtol 1e-4 (f32
differences compound through the updates, as in `test_torch_slice.py`),
the DP ledger and the uplink bits equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.channel as jch  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import power_control as jpc  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro_torch import channel as ch  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim  # noqa: E402
from repro_torch.core import power_control as pc  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from test_torch_round import configs  # noqa: E402

FAULTS = [dict(n_clients=5, dropout_p=0.3, straggler_p=0.1, seed=7),
          dict(n_clients=8, dropout_p=0.2, seed=0),
          dict(n_clients=3, dropout_p=0.999, seed=2),
          dict(n_clients=4, mtbf_rounds=5.0, repair_rounds=3, seed=1),
          dict(n_clients=6, dropout_p=0.1, straggler_p=0.05,
               mtbf_rounds=20.0, repair_rounds=7, seed=2**31 - 1),
          dict(n_clients=1, straggler_p=0.5, seed=11)]


@pytest.mark.parametrize("kw", FAULTS)
def test_fault_model_masks_bitwise(kw):
    ours, ref = fault.FaultModel(**kw), jfault.FaultModel(**kw)
    for t in range(80):
        a, b = ours.survival_mask(t), ref.survival_mask(t)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f"round {t}")
        assert a.sum() >= 1.0


@pytest.mark.parametrize("kw", [
    dict(n_clients=0), dict(n_clients=4, dropout_p=1.2),
    dict(n_clients=4, straggler_p=-0.1),
    dict(n_clients=4, dropout_p=0.7, straggler_p=0.5)])
def test_fault_model_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ref:
        jfault.FaultModel(**kw)
    with pytest.raises(ValueError) as ours:
        fault.FaultModel(**kw)
    assert str(ours.value) == str(ref.value)


def test_elastic_schedule_bitwise():
    events = ((10, 4), (20, 6), (5, 0), (30, 99))
    ours = fault.ElasticSchedule(n_clients=8, events=events)
    ref = jfault.ElasticSchedule(n_clients=8, events=events)
    for t in range(40):
        assert ours.active_k(t) == ref.active_k(t)
        np.testing.assert_array_equal(ours.membership_mask(t),
                                      ref.membership_mask(t))
    assert [ours.active_k(t) for t in (0, 5, 10, 25, 30)] == [8, 1, 4, 6, 8]


@pytest.mark.parametrize("which", ["none", "elastic", "fault", "both",
                                   "never_empty"])
def test_combined_mask_bitwise(which):
    def models(mod):
        fm = mod.FaultModel(5, dropout_p=0.999 if which == "never_empty"
                            else 0.4, seed=3)
        es = mod.ElasticSchedule(5, events=((3, 2), (6, 1) if which ==
                                            "never_empty" else (7, 4)))
        return {"none": (None, None), "elastic": (None, es),
                "fault": (fm, None)}.get(which, (fm, es))
    ours, ref = models(fault), models(jfault)
    for t in range(12):
        a = fault.combined_mask(t, *ours, n_clients=5)
        b = jfault.combined_mask(t, *ref, n_clients=5)
        np.testing.assert_array_equal(a, b, err_msg=f"round {t}")
        assert a.sum() >= 1.0


def test_combined_mask_requires_population():
    with pytest.raises(ValueError, match="n_clients"):
        fault.combined_mask(0, None, None)
    assert fault.combined_mask(
        0, None, fault.ElasticSchedule(n_clients=6)).shape == (6,)
    assert runtime.combined_mask is fault.combined_mask


def _schedules(rounds, k):
    return (pc.PowerSchedule(c=np.ones(rounds), sigma=np.zeros((rounds, k)),
                             scheme="perfect", n0=0.0),
            jpc.PowerSchedule(c=np.ones(rounds), sigma=np.zeros((rounds, k)),
                              scheme="perfect", n0=0.0))


def _pz_pair(rounds, outage_db):
    _, pz = configs(base, n_perturb=1)
    _, jpz = configs(jbase, n_perturb=1)
    chan = dict(n0=1.0, power=100.0, outage_db=outage_db)
    return (base.PairZeroConfig(**{**pz.__dict__, "rounds": rounds,
                                   "channel": base.ChannelConfig(**chan)}),
            jbase.PairZeroConfig(**{**jpz.__dict__, "rounds": rounds,
                                    "channel": jbase.ChannelConfig(**chan)}))


@pytest.mark.parametrize("bounds", [[(0, 10)], [(0, 6), (6, 10)],
                                    [(0, 3), (3, 7), (7, 8), (8, 10)]])
@pytest.mark.parametrize("outage_db", [None, 0.0])
def test_trace_masks_bitwise_across_chunks(bounds, outage_db):
    """The control trace's mask rows against `repro`'s `ctl["mask"]`: the
    FaultModel drawn in round order across chunk boundaries, the elastic
    events, the outage participation, and (at 0 dB) rounds that faults ×
    outage empty, re-admitting the strongest surviving client."""
    k, rounds = 5, 10
    pz, jpz = _pz_pair(rounds, outage_db)
    sched, jsched = _schedules(rounds, k)
    ctrace = ch.from_config(pz.channel).realize(pz.seed ^ 0xC4A7, rounds, k)
    jtrace = jch.from_config(jpz.channel).realize(jpz.seed ^ 0xC4A7, rounds,
                                                  k)
    fm = fault.FaultModel(k, dropout_p=0.5, straggler_p=0.1, seed=4)
    jfm = jfault.FaultModel(k, dropout_p=0.5, straggler_p=0.1, seed=4)
    es = fault.ElasticSchedule(k, events=((4, 3), (8, 5)))
    jes = jfault.ElasticSchedule(k, events=((4, 3), (8, 5)))
    ours, ref = [], []
    for a, b in bounds:
        tr = engine.build_trace(sched, pz, a, b, device="cpu", n_leaves=3,
                                fault=fm, elastic=es, channel=ctrace)
        np.testing.assert_array_equal(tr.ctl["mask"].numpy(), tr.host_masks)
        ours.append(tr.host_masks)
        ref.append(np.asarray(jeng.build_trace(
            jsched, jpz, a, b, fault=jfm, elastic=jes,
            channel=jtrace).ctl["mask"]))
    ours, ref = np.concatenate(ours), np.concatenate(ref)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert (ours.sum(axis=1) >= 1).all()
    if outage_db is not None:
        # a fresh model replays the survival rows: some round's survivors
        # were all in outage, and the re-admitted client is one of them
        fresh = fault.FaultModel(k, dropout_p=0.5, straggler_p=0.1, seed=4)
        survival = np.stack([fault.combined_mask(t, fresh, es, n_clients=k)
                             for t in range(rounds)])
        emptied = np.flatnonzero(
            (survival * ctrace.participation).sum(axis=1) == 0)
        assert emptied.size
        for t in emptied:
            assert ours[t].sum() == 1 and survival[t][ours[t] == 1] == 1


def test_elastic_event_boundaries_through_chunks():
    """Membership flips land on the event round even when a chunk spans
    it."""
    pz, _ = _pz_pair(10, None)
    sched, _ = _schedules(10, 5)
    es = fault.ElasticSchedule(n_clients=5, events=((4, 3), (8, 5)))
    masks = np.concatenate([
        engine.build_trace(sched, pz, a, b, device="cpu", n_leaves=2,
                           elastic=es).host_masks
        for a, b in ((0, 6), (6, 10))])
    np.testing.assert_array_equal(
        masks, np.stack([es.membership_mask(t) for t in range(10)]))
    assert masks[3].sum() == 5 and masks[4].sum() == 3
    assert masks[7].sum() == 3 and masks[8].sum() == 5


def _record_masks(monkeypatch, module):
    """Patch `module.build_trace` to keep each trace's host mask rows."""
    seen = []
    real = module.build_trace

    def build_trace(*args, **kwargs):
        trace = real(*args, **kwargs)
        seen.append(np.asarray(trace.host_masks))
        return trace
    monkeypatch.setattr(module, "build_trace", build_trace)
    return seen


def test_faulted_run_matches_reference(monkeypatch):
    """6 rounds of each package from the same seed with dropout,
    stragglers and an elastic event (nothing injected), loop engine."""
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    fkw = dict(dropout_p=0.3, straggler_p=0.1, seed=5)
    jseen = _record_masks(monkeypatch, jeng)
    ref = jfedsim.run(jcfg, jpz, JPipe("sst2", JSpec("sst2", 64, 24), 5, 4,
                                       seed=0), rounds=6, engine="loop",
                      fault=jfault.FaultModel(5, **fkw),
                      elastic=jfault.ElasticSchedule(5, ((3, 4),)),
                      dtype=jnp.float32)
    seen = _record_masks(monkeypatch, engine)
    res = fedsim.run(cfg, pz, FederatedPipeline(
        "sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0), rounds=6,
        fault=fault.FaultModel(5, **fkw),
        elastic=fault.ElasticSchedule(5, ((3, 4),)), device="cpu")
    masks, jmasks = np.concatenate(seen), np.concatenate(jseen)
    np.testing.assert_array_equal(masks, jmasks)
    assert masks.min() == 0 and (masks[3:, 4] == 0).all()
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    assert res.uplink_bits == ref.uplink_bits
    assert res.privacy_spent == ref.privacy_spent
    assert res.retry_attempts == ref.retry_attempts == {}
