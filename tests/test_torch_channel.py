"""Host-side numpy modules of the port's eighth slice against `repro`, all
bitwise: the channel models and wrappers (and the stack `from_config`
composes), the power-control schedules of every transport and scheme, the
sign transport's DP costs, the control trace's mask and CSI rows, and the
squad and lm tasks."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.channel as jch  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import power_control as jpc  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro_torch import channel as ch  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import power_control as pc  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data import tasks  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402

# the wrapped stack of chip_smoke's sign path
WRAPPED = dict(model="rician", rician_k=3.0, cell_radius=100.0,
               phase_err_std=0.1, outage_db=-10.0)


def _same_trace(ours, ref):
    for f in ("h", "phase", "participation"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert sorted(ours.meta) == sorted(ref.meta)
    assert (ours.rounds, ours.n_clients) == (ref.rounds, ref.n_clients)
    for view in ("gain", "csi"):
        a, b = getattr(ours, view), getattr(ref, view)
        assert a.dtype == b.dtype, view
        np.testing.assert_array_equal(a, b, err_msg=view)
    np.testing.assert_array_equal(ours.mean_power(), ref.mean_power())
    assert ours.outage_rate() == ref.outage_rate()
    if "client_gains" in ref.meta:
        np.testing.assert_array_equal(ours.meta["client_gains"],
                                      ref.meta["client_gains"])


@pytest.mark.parametrize("name,kw", [
    ("rayleigh", {}), ("static", {}),
    ("rician", dict(k_factor=0.0)), ("rician", dict(k_factor=3.0)),
    ("rician", dict(k_factor=12.5)),
    ("ar1", dict(rho=0.0)), ("ar1", dict(rho=0.5)), ("ar1", dict(rho=0.97))])
@pytest.mark.parametrize("seed,rounds,k", [(0, 8, 5), (0xC4A7, 800, 5),
                                           (12345, 33, 7)])
def test_base_models_bitwise(name, kw, seed, rounds, k):
    _same_trace(ch.get(name)(**kw).realize(seed, rounds, k),
                jch.get(name)(**kw).realize(seed, rounds, k))


@pytest.mark.parametrize("i", range(6))
def test_trace_views_bitwise(i):
    """The six views of the trace (`rounds`, `n_clients`, `gain`, `csi`,
    `mean_power()`, `outage_rate()`) on wrapped traces: CSI error gives
    cos θ < 1, outage an outage rate > 0, path loss uneven mean powers."""
    ours = _wrappers(ch)[i].realize(0xC4A7, 64, 6)
    ref = _wrappers(jch)[i].realize(0xC4A7, 64, 6)
    _same_trace(ours, ref)
    assert ours.rounds == 64 and ours.n_clients == 6
    assert ours.gain.dtype == np.complex128
    np.testing.assert_array_equal(np.abs(ours.gain), np.abs(ref.gain))


@pytest.mark.parametrize("seed", [0, 0xC4A7, 99])
def test_rician_k0_and_ar1_rho0_are_rayleigh_bitwise(seed):
    ray = ch.RayleighFading().realize(seed, 64, 5)
    for model in (ch.RicianFading(k_factor=0.0), ch.AR1Correlated(rho=0.0)):
        np.testing.assert_array_equal(model.realize(seed, 64, 5).h, ray.h)


def test_bessel_j0_and_jakes_rho_equal_floats():
    for x in np.concatenate([np.linspace(-12.0, 12.0, 97),
                             [0.0, 2.404825, 2.999999, 3.0, 1e-9, 250.0]]):
        assert ch.bessel_j0(float(x)) == jch.bessel_j0(float(x))
    for f_d in (0.0, 1.0, 10.0, 100.0, 382.7, 1000.0):
        for tau in (1e-4, 1e-3, 5e-3):
            assert ch.jakes_rho(f_d, tau) == jch.jakes_rho(f_d, tau)
    for bad in ((-1.0, 1e-3), (10.0, 0.0)):
        with pytest.raises(ValueError):
            ch.jakes_rho(*bad)
        with pytest.raises(ValueError):
            jch.jakes_rho(*bad)


def _wrappers(mod):
    """The same wrapper instances over the rician base, in both packages."""
    rician = mod.RicianFading(k_factor=3.0)
    return [
        mod.PathLossGeometry(base=rician, cell_radius=100.0),
        mod.PathLossGeometry(base=mod.RayleighFading(), cell_radius=250.0,
                             pathloss_exp=3.0, shadow_std_db=8.0,
                             shadow_corr=0.3),
        mod.ImperfectCSI(base=rician, phase_err_std=0.1),
        mod.ImperfectCSI(base=rician, phase_err_std=0.0),
        mod.OutageModel(base=rician, threshold_db=-10.0),
        # +10 dB empties whole rounds: the strongest client is re-admitted
        mod.OutageModel(base=mod.RayleighFading(), threshold_db=10.0),
    ]


@pytest.mark.parametrize("i", range(6))
@pytest.mark.parametrize("seed,rounds,k", [(0xC4A7, 32, 5), (7, 200, 9)])
def test_wrappers_bitwise(i, seed, rounds, k):
    ours, ref = _wrappers(ch)[i], _wrappers(jch)[i]
    _same_trace(ours.realize(seed, rounds, k), ref.realize(seed, rounds, k))
    if isinstance(ref, jch.PathLossGeometry):
        np.testing.assert_array_equal(ours.client_gains(seed, k),
                                      ref.client_gains(seed, k))


@pytest.mark.parametrize("kw", [
    {}, dict(model="static"), dict(model="ar1", ar1_rho=0.3),
    dict(model="ar1", doppler_hz=50.0, round_duration_s=2e-3),
    dict(fading="rician", rician_k=5.0),
    WRAPPED,
    {**WRAPPED, "shadow_std_db": 6.0, "shadow_corr": 0.8},
    dict(model="rayleigh", outage_db=10.0),
    dict(model="ar1", cell_radius=50.0, pathloss_exp=2.5, outage_db=-3.0,
         phase_err_std=0.4)])
def test_from_config_stack_bitwise(kw):
    ours = ch.from_config(base.ChannelConfig(**kw))
    ref = jch.from_config(jbase.ChannelConfig(**kw))
    assert repr(ours).replace("repro_torch", "repro") == repr(ref)
    for seed, rounds in ((0 ^ 0xC4A7, 32), (3, 800)):
        _same_trace(ch.realize_from_config(base.ChannelConfig(**kw), seed,
                                           rounds, 5),
                    ref.realize(seed, rounds, 5))


@pytest.mark.parametrize("kw", [
    dict(model="rayleigh", doppler_hz=10.0),
    dict(shadow_std_db=4.0),
    dict(model="geometry"), dict(model="imperfect_csi"), dict(model="outage"),
    dict(model="nakagami")])
def test_from_config_guards_raise_value_error(kw):
    with pytest.raises(ValueError) as ref_err:
        jch.from_config(jbase.ChannelConfig(**kw))
    with pytest.raises(ValueError) as our_err:
        ch.from_config(base.ChannelConfig(**kw))
    assert str(our_err.value).split(":")[0] == \
        str(ref_err.value).split(":")[0]


@pytest.mark.parametrize("mk", [
    lambda m: m.RicianFading(k_factor=-1.0),
    lambda m: m.AR1Correlated(rho=1.0),
    lambda m: m.PathLossGeometry(cell_radius=0.0),
    lambda m: m.PathLossGeometry(shadow_std_db=3.0, shadow_corr=1.5),
    lambda m: m.ImperfectCSI(phase_err_std=-0.1)])
def test_invalid_parameters_raise_value_error(mk):
    for mod in (jch, ch):
        with pytest.raises(ValueError):
            mk(mod).realize(0, 4, 3)


def test_registry_names_match_reference():
    assert ch.available() == jch.available()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _h(wrapped: bool, rounds: int) -> np.ndarray:
    cc = jbase.ChannelConfig(**(WRAPPED if wrapped else {}))
    return jch.realize_from_config(cc, 0 ^ 0xC4A7, rounds, 5).h


def _same_schedule(ours, ref):
    np.testing.assert_array_equal(ours.c, ref.c)
    np.testing.assert_array_equal(ours.sigma, ref.sigma)
    assert (ours.scheme, ours.zeta, ours.n0) == (ref.scheme, ref.zeta,
                                                 ref.n0)


SOLVE_KW = dict(power=100.0, n0=1.0, epsilon=5.0, delta=0.01)


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("rounds", [8, 32, 800])
def test_schedules_bitwise(wrapped, rounds):
    h = _h(wrapped, rounds)
    sign_kw = dict(n_clients=5, e0=0.4960, contraction_a_tilde=0.998)
    cases = [
        ("static_analog", dict(gamma=5.0)),
        ("reversed_analog", dict(gamma=5.0, contraction_a=0.998)),
        ("solve_analog", dict(gamma=5.0, contraction_a=0.998)),
        ("solve_sign", sign_kw), ("static_sign", {}),
        ("reversed_sign", sign_kw)]
    for fn, kw in cases:
        ours = getattr(pc, fn)(h, **SOLVE_KW, **kw)
        ref = getattr(jpc, fn)(h, **SOLVE_KW, **kw)
        _same_schedule(ours, ref)
        for gamma, d in ((5.0, 1000), (1.0, 125_000_000)):
            np.testing.assert_array_equal(
                pc.transmit_power(ours, h, gamma, d),
                jpc.transmit_power(ref, h, gamma, d))
    flat = dict(SOLVE_KW, gamma=5.0, n_clients=5, e0=0.4960,
                contraction_a=0.998, contraction_a_tilde=0.998)
    for variant in ("analog", "sign"):
        for scheme in ("solution", "static", "reversed", "perfect"):
            _same_schedule(pc.make_schedule(variant, scheme, h, **flat),
                           jpc.make_schedule(variant, scheme, h, **flat))
    for mk in (pc, jpc):
        with pytest.raises(ValueError):
            mk.make_schedule("fo", "solution", h, **flat)


def _pz(mod, mechanism, scheme, wrapped=False, rounds=800, **kw):
    return mod.PairZeroConfig(
        variant="sign" if mechanism == "sign" else "analog", n_clients=5,
        rounds=rounds,
        zo=mod.ZOConfig(mu=1e-3, lr=5e-3, clip_gamma=5.0, n_perturb=4),
        channel=mod.ChannelConfig(n0=1.0, power=100.0,
                                  **(WRAPPED if wrapped else {})),
        dp=mod.DPConfig(epsilon=5.0, delta=0.01, **kw),
        power=mod.PowerControlConfig(scheme=scheme),
        transport=mod.TransportConfig(mechanism=mechanism, scheme=scheme),
        seed=0)


MECH_SCHEMES = [(m, s) for m in ("analog", "sign")
                for s in ("solution", "static", "reversed", "perfect")] \
    + [("perfect", "perfect")]


@pytest.mark.parametrize("mechanism,scheme", MECH_SCHEMES)
@pytest.mark.parametrize("wrapped", [False, True])
def test_transport_schedules_and_dp_costs_bitwise(mechanism, scheme,
                                                  wrapped):
    pz, jpz = (_pz(m, mechanism, scheme, wrapped, rounds=32)
               for m in (base, jbase))
    trace = jch.realize_from_config(jpz.channel, 0 ^ 0xC4A7, 32, 5)
    mech, jmech = tp.resolve(pz), jtp.resolve(jpz)
    assert type(mech).__name__ == type(jmech).__name__
    ours, ref = mech.make_schedule(trace, pz), jmech.make_schedule(trace,
                                                                   jpz)
    _same_schedule(ours, ref)
    charged = mech.charges_privacy(ours, pz)
    assert charged == jmech.charges_privacy(ref, jpz) == (scheme != "perfect")
    for t0, t1 in ((0, 32), (3, 11)) if charged else ():
        np.testing.assert_array_equal(mech.round_dp_costs(ours, t0, t1, pz),
                                      jmech.round_dp_costs(ref, t0, t1, jpz))
    # the legacy (variant, scheme) strings resolve the same mechanism
    if mechanism != "perfect":
        assert tp.from_strings(mechanism, scheme) == mech


@pytest.mark.parametrize("wrapped", [False, True])
def test_sign_schedule_silences_727_of_800_rounds(wrapped):
    """Theorem 4 at the training CLI's defaults leaves the first 727 of 800
    rounds silent (c = 0), as the reference does; at horizon 32 no round
    is; the reversed schedule silences the last rounds instead."""
    h = _h(wrapped, 800)
    kw = dict(SOLVE_KW, n_clients=5, e0=0.4960, contraction_a_tilde=0.998)
    ours, ref = pc.solve_sign(h, **kw), jpc.solve_sign(h, **kw)
    silent = np.flatnonzero(ours.c == 0.0)
    np.testing.assert_array_equal(silent, np.flatnonzero(ref.c == 0.0))
    np.testing.assert_array_equal(silent, np.arange(727))
    assert (pc.solve_sign(_h(wrapped, 32), **kw).c > 0).all()
    rev = pc.reversed_sign(h, **kw)
    assert rev.c[0] > 0 and rev.c[-1] == 0.0
    # silent rounds cost no privacy; the sign DP sensitivity is 1 (γ = 1)
    pz = _pz(base, "sign", "solution")
    costs = tp.SignOTA().round_dp_costs(ours, 0, 800, pz)
    assert (costs[:727] == 0.0).all() and (costs[727:] > 0).all()
    np.testing.assert_array_equal(costs, tp.ota_dp_costs(ours, 0, 800, 1.0))
    np.testing.assert_array_equal(
        costs, jtp.ota_dp_costs(ref, 0, 800, 1.0))


# ---------------------------------------------------------------------------
# control trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chan,rounds", [
    (WRAPPED, 32), ({**WRAPPED, "outage_db": 10.0}, 32),
    (dict(model="ar1", outage_db=3.0, phase_err_std=0.3), 40), ({}, 16)])
@pytest.mark.parametrize("mechanism", ["analog", "sign"])
def test_control_trace_rows_match_reference(chan, rounds, mechanism):
    """build_trace's mask, g and host_masks (and c, sigma, n0, the DP
    costs) equal the reference's under a realized channel, over any chunk
    of the horizon; under +10 dB most rounds empty and re-admit their
    strongest client."""
    import torch
    pz, jpz = (_pz(m, mechanism, "solution", rounds=rounds) for m in
               (base, jbase))
    pz = dataclasses.replace(pz, channel=base.ChannelConfig(**chan))
    jpz = dataclasses.replace(jpz, channel=jbase.ChannelConfig(**chan))
    trace = jch.realize_from_config(jpz.channel, 0 ^ 0xC4A7, rounds, 5)
    ours_trace = ch.realize_from_config(pz.channel, 0 ^ 0xC4A7, rounds, 5)
    sched = jtp.resolve(jpz).make_schedule(trace, jpz)
    for t0, t1 in ((0, rounds), (5, 13)):
        ours = engine.build_trace(sched, pz, t0, t1,
                                  device=torch.device("cpu"), n_leaves=3,
                                  channel=ours_trace)
        ref = jeng.build_trace(sched, jpz, t0, t1, channel=trace)
        for k in ("c", "sigma", "n0", "mask", "g"):
            np.testing.assert_array_equal(ours.ctl[k].numpy(),
                                          np.asarray(ref.ctl[k]), err_msg=k)
        np.testing.assert_array_equal(ours.host_masks, ref.host_masks)
        assert ours.host_masks.dtype == ref.host_masks.dtype
        np.testing.assert_array_equal(ours.acct_cost, ref.acct_cost)
        assert ours.charged == ref.charged
        assert (ours.host_masks.sum(axis=1) >= 1).all()
        if chan.get("outage_db") == 10.0:
            assert (ours.host_masks.sum(axis=1) == 1).sum() > (t1 - t0) // 2


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["squad", "lm"])
@pytest.mark.parametrize("seed,vocab,seq", [(0, 64, 24), (3, 50272, 64)])
def test_task_samplers_and_pipelines_bitwise(task, seed, vocab, seq):
    spec, jspec = tasks.TaskSpec(task, vocab, seq), \
        jtasks.TaskSpec(task, vocab, seq)
    sampler = {"squad": "sample_squad", "lm": "sample_lm"}[task]
    a = getattr(tasks, sampler)(spec, np.random.default_rng(seed), 6)
    b = getattr(jtasks, sampler)(jspec, np.random.default_rng(seed), 6)
    c = tasks.sample(task, spec, np.random.default_rng(seed), 6)
    for out in (a, c):
        assert sorted(out) == sorted(b)
        for k in b:
            assert out[k].dtype == b[k].dtype
            np.testing.assert_array_equal(out[k], b[k])
    ours = FederatedPipeline(task, spec, 5, 8, seed)
    ref = JPipe(task, jspec, 5, 8, seed)
    for t in (0, 1, 799):
        x, y = ours.batch(t), ref.batch(t)
        assert sorted(x) == sorted(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])
    ebatch = ref.eval_batch(16)
    for k, v in ebatch.items():
        np.testing.assert_array_equal(ours.eval_batch(16)[k], v)
    logits = np.random.default_rng(seed).normal(size=(16, 1, vocab))
    logits[:5, -1, ebatch["targets"][:5, -1]] = 1e3
    assert tasks.accuracy(logits, ebatch) == jtasks.accuracy(logits, ebatch)


def test_task_spec_fields_match_reference():
    # the reference's dirichlet_alpha is read by no code there, so the port
    # leaves it out; the fields it keeps are the reference's, in order
    ours = [(f.name, f.default) for f in dataclasses.fields(tasks.TaskSpec)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jtasks.TaskSpec)]
    assert ours == [f for f in ref if f[0] != "dirichlet_alpha"]
    # a per-client bias (non-IID split) is not implemented: it raises
    with pytest.raises(NotImplementedError, match="client_bias"):
        tasks.sample("squad", tasks.TaskSpec("squad", 64, 24),
                     np.random.default_rng(0), 6, client_bias=np.ones(2))
