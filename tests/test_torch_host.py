"""Host-side numpy modules of the port against `repro`, all bitwise:
pipeline batches, the Rayleigh channel trace, the Theorem-3 `solution`
schedule, per-round DP costs and the accountant's ledger."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.channel import RayleighFading as JRayleigh  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import dp as jdp  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro_torch import channel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import dp, engine, transport  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402


def _pz(mod, **kw):
    return mod.PairZeroConfig(
        n_clients=5, rounds=kw.get("rounds", 800),
        zo=mod.ZOConfig(mu=1e-3, lr=5e-3, clip_gamma=kw.get("gamma", 5.0),
                        n_perturb=4),
        channel=mod.ChannelConfig(n0=1.0, power=kw.get("power", 100.0)),
        dp=mod.DPConfig(epsilon=kw.get("eps", 5.0), delta=0.01),
        power=mod.PowerControlConfig(scheme="solution"),
        transport=mod.TransportConfig(mechanism="analog", scheme="solution"),
        seed=kw.get("seed", 0))


@pytest.mark.parametrize("seed,vocab,seq", [(0, 64, 24), (3, 50272, 64)])
def test_pipeline_batches_bitwise(seed, vocab, seq):
    ours = FederatedPipeline("sst2", TaskSpec("sst2", vocab, seq), 5, 8, seed)
    ref = JPipe("sst2", JSpec("sst2", vocab, seq), 5, 8, seed)
    for t in (0, 1, 799):
        a, b = ours.batch(t), ref.batch(t)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 0xC4A7, 12345])
def test_rayleigh_trace_bitwise(seed):
    ours = channel.from_config(base.ChannelConfig()).realize(seed, 800, 5)
    ref = JRayleigh().realize(seed, 800, 5)
    for f in ("h", "phase", "participation"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))


@pytest.mark.parametrize("kw", [dict(), dict(rounds=3), dict(eps=0.5),
                                dict(power=1e4, rounds=50),
                                dict(gamma=100.0, seed=7)])
def test_solution_schedule_and_dp_costs_bitwise(kw):
    pz, jpz = _pz(base, **kw), _pz(jbase, **kw)
    h = JRayleigh().realize(pz.seed ^ 0xC4A7, pz.rounds, 5)
    sched = transport.resolve(pz).make_schedule(h, pz)
    jsched = jtp.resolve(jpz).make_schedule(h, jpz)
    np.testing.assert_array_equal(sched.c, jsched.c)
    np.testing.assert_array_equal(sched.sigma, jsched.sigma)
    assert (sched.zeta, sched.n0, sched.scheme) == \
        (jsched.zeta, jsched.n0, jsched.scheme)
    for t0, t1 in ((0, pz.rounds), (1, min(9, pz.rounds))):
        np.testing.assert_array_equal(
            transport.ota_dp_costs(sched, t0, t1, 5.0),
            jtp.ota_dp_costs(jsched, t0, t1, 5.0))


def test_accountant_ledger_bitwise_left_fold():
    """Chunked charging and the affordable-rounds lookahead fold in the
    reference's exact float64 order (never a compensated sum)."""
    rng = np.random.default_rng(5)
    ours, ref = dp.PrivacyAccountant(5.0, 0.01), jdp.PrivacyAccountant(5.0,
                                                                      0.01)
    assert ours.budget == ref.budget == jdp.r_dp(5.0, 0.01)
    for n in (1, 7, 3, 40):
        costs = rng.random(n) * 0.01
        ours.spend_batch(costs)
        ref.spend_batch(costs)
        assert ours.spent == ref.spent
    assert ours.history == ref.history
    np.testing.assert_array_equal(
        dp.cumulative_spend(ours.history, 0.25),
        jdp.cumulative_spend(ref.history, 0.25))
    for budget_left in (0.0, 1e-3, 0.05):
        costs = rng.random(16) * 0.01
        for acct in (ours, ref):
            acct.spent = acct.budget - budget_left
        tr = engine.ControlTrace(t0=0, ctl={"seed": np.zeros(16)},
                                 acct_cost=costs, charged=True)
        jtr = jeng.ControlTrace(t0=0, ctl={"seed": np.zeros(16)},
                                acct_cost=costs, charged=True)
        assert engine.affordable_rounds(ours, tr) == \
            jeng.affordable_rounds(ref, jtr)


def test_control_trace_matches_reference_rows():
    """build_trace's seeds, gains, sigma, n0, mask, g and DP costs equal the
    reference's control trace for the same schedule (noise is the port's
    own data: the reference's threefry keys are not ported)."""
    import torch
    pz, jpz = _pz(base, rounds=16), _pz(jbase, rounds=16)
    h = JRayleigh().realize(pz.seed ^ 0xC4A7, 16, 5)
    sched = jtp.resolve(jpz).make_schedule(h, jpz)
    ours = engine.build_trace(sched, pz, 3, 16, device=torch.device("cpu"),
                              n_leaves=4)
    ref = jeng.build_trace(sched, jpz, 3, 16)
    np.testing.assert_array_equal(ours.ctl["seed"], np.asarray(ref.ctl["seed"]))
    for k in ("c", "sigma", "n0", "mask", "g"):
        np.testing.assert_array_equal(ours.ctl[k].numpy(),
                                      np.asarray(ref.ctl[k]))
    np.testing.assert_array_equal(ours.acct_cost, ref.acct_cost)
    assert ours.charged == ref.charged
    assert ours.ctl["noise"].shape == (13, 4, 6)
    again = engine.build_trace(sched, pz, 7, 9, device=torch.device("cpu"),
                               n_leaves=4)
    np.testing.assert_array_equal(again.ctl["noise"].numpy(),
                                  ours.ctl["noise"][4:6].numpy())


def test_configs_field_for_field():
    import dataclasses
    for name in ("ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
                 "HybridConfig", "FrontendConfig", "ZOConfig",
                 "ChannelConfig", "DPConfig", "PowerControlConfig",
                 "TransportConfig", "PairZeroConfig"):
        ours = {f.name: f.default for f in
                dataclasses.fields(getattr(base, name))}
        ref = {f.name: f.default for f in
               dataclasses.fields(getattr(jbase, name))}
        assert ours == ref, name
