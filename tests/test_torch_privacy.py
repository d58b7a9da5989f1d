"""The privacy subsystem (`repro_torch.privacy`: adversary, capture hook,
attacks, audit), the transports' observation model, the training CLI's
scenario flags and the differentiable kernel vjp, against `repro`.

Tolerances:
- `dp.epsilon_for_budget` (host float64, the same ops): bitwise;
  `binom_logcdf` and `clopper_pearson_upper`: 1e-12 relative (numpy's
  reductions over the same terms);
- each transport's `observe`, `transmitted`, `canary_payload` and
  `observation_spec` on the same payloads and key: the OTA scalar y within
  1e-5 of max(1, |y|) (its normals are the reference's threefry draws
  within C6's 4 ulps), the digital q (bitwise uniforms) bitwise, the rest
  equal;
- `paired_trace_statistics` at 64 trials × 8 rounds: stat_in and stat_out
  rtol 1e-5 (the same normals within 4 ulps, summed over rounds in
  another order); `audit_transport`'s ε̂ and `dominated` equal at these
  seeds (a count flips only if a statistic crosses a threshold within
  that tolerance);
- `seed_replay` on the port's tiny-run capture (obs_y under analog,
  obs_q under smart_digital) through both packages' attack: equal
  (host numpy); the capture itself: obs_y is the decode's y and obs_q
  the decoded slots, checked inside the port;
- `client_gradient` against `repro`'s: within 1e-4 of max|g|;
  `zo_gradient_estimate`: within 4 f32 ulps of max|ĝ| (the z streams are
  the same counter hash, z within a few ulps, `test_torch_model.py`);
- `dlg`, 20 steps on the tiny dense config from the same gradient and
  dummy draw: the same tokens; residuals rtol 1e-5 — each step
  differentiates a gradient of a forward whose f32 sums run in another
  order, and Adam's update divides by √v, so the two dummies part by a
  few ulps a step and the residuals by more; at 20 steps they differ by
  4.4e-7 relative (seen), and the bound leaves a decade and more;
- the CLI at a tiny config (2 rounds, --audit --audit-trials 64
  --byzantine sign_flip --defense robust_decode --desync-frac 0.25)
  against `repro.launch.train.main`: the `byzantine` and `desync` keys
  equal, the `audit` keys equal but seed replay's RMSEs (rtol 1e-4: the
  captured y and payloads of two trajectories within f32 tolerance);
- port-only: capture is passive (losses, p̂ and weights bitwise with the
  adversary on and off, ZO and FO), scan ≡ loop with capture on (the
  observations too), and the kernel vjp passes `gradgradcheck` in f64.
"""
import contextlib
import dataclasses
import io
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import privacy as jpv  # noqa: E402
from repro.channel import RayleighFading  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import dp as jdp  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.privacy import audit as jaudit  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import privacy as pv  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import dp, fedsim, zo  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.privacy import audit  # noqa: E402
from test_torch_round import _batch, configs  # noqa: E402

K = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny runs are thousands of small ops: one intra-op thread
    runs them faster than a pool sharing the machine with the other test
    workers. The thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_epsilon_and_binomial_tails_match_reference():
    for spent in (0.0, 1e-6, 0.37, 2.5, 41.0):
        for delta in (1e-5, 0.01, 0.3):
            assert dp.epsilon_for_budget(spent, delta) == \
                jdp.epsilon_for_budget(spent, delta)
    with pytest.raises(ValueError):
        dp.epsilon_for_budget(-1.0, 0.01)
    for k, n, p in ((0, 10, 0.1), (3, 64, 0.2), (30, 1500, 0.03),
                    (7, 7, 0.5), (2, 9, 0.0), (2, 9, 1.0)):
        a, b = audit.binom_logcdf(k, n, p), jaudit.binom_logcdf(k, n, p)
        assert a == b or abs(a - b) <= 1e-12 * abs(b)
    for k, n, conf in ((0, 64, 0.95), (5, 64, 0.99), (40, 1500, 0.995),
                       (64, 64, 0.95), (0, 0, 0.95)):
        a = audit.clopper_pearson_upper(k, n, conf)
        b = jaudit.clopper_pearson_upper(k, n, conf)
        assert abs(a - b) <= 1e-12 * abs(b)


def _both(mech, scheme="solution"):
    _, pz = configs(base)
    _, jpz = configs(jbase)
    t = tp.get(mech).from_config(base.TransportConfig(
        mechanism=mech, scheme=scheme), pz)
    jt = jtp.get(mech).from_config(jbase.TransportConfig(
        mechanism=mech, scheme=scheme), jpz)
    return t, jt, pz, jpz


@pytest.mark.parametrize("mech,scheme", [
    ("analog", "solution"), ("sign", "solution"), ("perfect", "perfect"),
    ("digital", "solution"), ("smart_digital", "solution"),
    ("fo", "solution")])
def test_observation_model_matches_reference(mech, scheme):
    t, jt, pz, jpz = _both(mech, scheme)
    rng = np.random.default_rng(4)
    p = rng.uniform(-5, 5, K).astype(np.float32)
    p[1] = 0.0
    host = {"c": np.float32(0.6), "n0": np.float32(1.0),
            "sigma": rng.uniform(0, 0.4, K).astype(np.float32),
            "mask": np.array([1, 0, 1, 1, 1], np.float32),
            "g": np.cos(rng.normal(size=K) * 0.2).astype(np.float32),
            "dsync_a": np.cos(rng.normal(size=K) * 0.3).astype(np.float32)}
    jkey = jax.random.fold_in(jax.random.key(9), 2)
    key = prng.fold_in(prng.key(9), 2)
    ctl = {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}
    ctl.update(tp.key_draws(t.draws, key, K))
    jctl = {k: jnp.asarray(v) for k, v in host.items()}
    got = t.observe(torch.from_numpy(p), ctl)
    want = jt.observe(jnp.asarray(p), jctl, jkey)
    assert got.keys() == want.keys()
    spec, jspec = t.observation_spec(K), jt.observation_spec(K)
    assert {k: tuple(v.shape) for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in jspec.items()}
    for name in got:
        w = np.asarray(want[name])
        if name == "y":
            assert abs(float(got[name]) - float(w)) <= 1e-5 * max(
                1.0, abs(float(w)))
        else:
            np.testing.assert_array_equal(got[name].numpy(), w)
    np.testing.assert_array_equal(t.transmitted(torch.from_numpy(p)).numpy(),
                                  np.asarray(jt.transmitted(jnp.asarray(p))))
    assert t.canary_payload(pz) == jt.canary_payload(jpz)
    if got:
        adv = pv.Adversary().observe(t, torch.from_numpy(p), ctl)
        assert {k[len(pv.OBS_PREFIX):] for k in adv} == set(got)


@pytest.fixture(scope="module")
def schedule():
    _, pz = configs(base)
    h = RayleighFading().realize(3, 8, K)
    return (tp.AnalogOTA().make_schedule(h, pz),
            jtp.AnalogOTA().make_schedule(h, configs(jbase)[1]))


@pytest.mark.parametrize("mech", ["analog", "sign"])
def test_audit_statistics_match_reference(mech, schedule):
    t, jt, pz, jpz = _both(mech)
    sched, jsched = schedule
    np.testing.assert_array_equal(sched.c, jsched.c)
    canary = t.canary_payload(pz)
    stats = audit.paired_trace_statistics(
        t, sched, canary, rounds=8, n_clients=K, trials=64, device="cpu")
    jstats = jaudit.paired_trace_statistics(
        jt, jsched, canary, rounds=8, n_clients=K, trials=64)
    for got, want in zip(stats, jstats):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    res = pv.audit_transport(t, sched, pz, trials=64, device="cpu")
    jres = jpv.audit_transport(jt, jsched, jpz, trials=64)
    assert res.eps_hat == jres.eps_hat and res.dominated == jres.dominated
    assert res.eps_analytic == jres.eps_analytic and res.spent == jres.spent
    assert res.to_dict().keys() == jres.to_dict().keys()
    digital = pv.audit_transport(tp.SmartDigital(), sched, pz, trials=64,
                                 device="cpu")
    assert digital.eps_hat == math.inf and not digital.meta["auditable"]
    with pytest.raises(ValueError, match="no scalar 'y'"):
        audit.paired_trace_statistics(tp.DigitalTDMA(), sched, 1.0,
                                      rounds=8, n_clients=K, trials=4,
                                      device="cpu")


def _pipe():
    return FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), K, 4, seed=0)


def _params(seed=0):
    jparams = jreg.init_params(jax.random.key(seed), configs(jbase)[0])
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


ROUNDS = 3


def _captured(mech, adversary=True, **kw):
    cfg, pz = configs(base, n_perturb=1)
    pz = dataclasses.replace(pz, transport=base.TransportConfig(
        mechanism=mech))
    hook = pv.AttackHook()
    res = fedsim.run(cfg, pz, _pipe(), ROUNDS, params=_params()[1],
                     device="cpu",
                     adversary=pv.Adversary() if adversary else None,
                     hooks=[hook], **kw)
    return res, hook


@pytest.fixture(scope="module")
def analog_capture():
    """One analog run with the capture on, shared by the tests that read
    it."""
    return _captured("analog")


@pytest.mark.parametrize("mech", ["analog", "smart_digital"])
def test_seed_replay_on_a_captured_run(mech, analog_capture):
    res, hook = analog_capture if mech == "analog" else _captured(mech)
    obs, payloads = hook.observations(), hook.payloads()
    name = "obs_y" if mech == "analog" else "obs_q"
    assert list(obs) == [name] and hook.rounds == list(range(ROUNDS))
    assert payloads.shape == (ROUNDS, K)
    assert hook.k_eff().tolist() == [5.0] * ROUNDS
    if mech == "analog":
        # the capture is the decode's y: p̂ of a one-direction round is
        # y / (K_eff c)
        c = res.schedule.c[:ROUNDS].astype(np.float32)
        np.testing.assert_allclose(obs[name] / (K * c), res.p_hats,
                                   rtol=1e-6)
    else:
        np.testing.assert_allclose(obs[name].mean(axis=1), res.p_hats,
                                   rtol=1e-6)
    sent = res.transport.transmitted(payloads)
    ours = pv.get("seed_replay")().run(obs, sent, res.schedule.c,
                                       hook.k_eff())
    ref = jpv.get("seed_replay")().run(obs, sent, res.schedule.c,
                                       hook.k_eff())
    np.testing.assert_array_equal(ours.pop("estimates"),
                                  ref.pop("estimates"))
    assert ours == ref
    assert ours["per_client_exposed"] == (mech != "analog")


def test_capture_is_passive_and_scan_equals_loop(analog_capture):
    plain, _ = _captured("analog", adversary=False)
    loop, hook = analog_capture
    scan, shook = _captured("analog", engine="scan", chunk_rounds=2)
    for other in (loop, scan):
        assert other.losses == plain.losses and other.p_hats == plain.p_hats
        for (path, x), (_, y) in zip(zo.flatten(other.params),
                                     zo.flatten(plain.params)):
            assert torch.equal(x, y), path
    np.testing.assert_array_equal(shook.observations()["obs_y"],
                                  hook.observations()["obs_y"])
    np.testing.assert_array_equal(shook.payloads(), hook.payloads())

    # FO: the captured gradient is client 0's own, and capture is passive
    fo_runs = [_captured("fo", adversary=a, **kw) for a, kw in (
        (False, {}), (True, {}), (True, dict(engine="scan",
                                             chunk_rounds=2)))]
    (off, _), (on, fhook), (fscan, fshook) = fo_runs
    for other in (on, fscan):
        assert other.losses == off.losses
        for tree in ("params", "m", "v"):
            a = other.params if tree == "params" else other.opt_state[tree]
            b = off.params if tree == "params" else off.opt_state[tree]
            for (path, x), (_, y) in zip(zo.flatten(a), zo.flatten(b)):
                assert torch.equal(x, y), (tree, path)
    g0 = fhook.observations()["obs_grad0"]
    np.testing.assert_array_equal(fshook.observations()["obs_grad0"], g0)
    cfg = configs(base)[0]
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                 else v)
             for k, v in _pipe().batch(0).items() if k != "labels"}
    want = pv.client_gradient(cfg, _params()[1], batch, client=0)
    assert g0.shape == (ROUNDS, cfg.param_count())
    np.testing.assert_array_equal(g0[0], want.numpy())


def test_gradient_oracles_match_reference():
    cfg, jcfg = configs(base)[0], configs(jbase)[0]
    jparams, params = _params(2)
    host = _batch(vocab=64)
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                 else v) for k, v in host.items()}
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    got = pv.client_gradient(cfg, params, batch, 3).numpy()
    want = np.asarray(jax.jit(lambda p, b: jpv.client_gradient(
        jcfg, p, b, 3))(jparams, jbatch))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    seed = jzo.perturb_seed(jzo.round_seed(0, 3), 1)
    got = pv.zo_gradient_estimate(params, int(seed), 0.37).numpy()
    want = np.asarray(jax.jit(jpv.zo_gradient_estimate)(jparams, seed,
                                                         0.37))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * np.finfo(np.float32).eps
                               * np.abs(want).max())
    assert pv.reconstruction_error(torch.from_numpy(got), want) == \
        jpv.reconstruction_error(got, want)


def test_dlg_matches_reference_for_twenty_steps():
    cfg, jcfg = configs(base)[0], configs(jbase)[0]
    jparams, params = _params(1)
    host = _batch(k=1, b=2, s=8, vocab=64, seed=5)
    host["mask"][:] = 1.0
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    g_star = np.asarray(jpv.client_gradient(jcfg, jparams, jbatch, 0))
    kw = dict(targets=host["targets"][0], mask=host["mask"][0],
              true_tokens=host["tokens"][0])
    ref = jpv.get("dlg")(steps=20).run(jcfg, jparams, g_star, **kw)
    ours = pv.get("dlg")(steps=20).run(cfg, params, g_star, **kw)
    np.testing.assert_array_equal(ours["tokens"], ref["tokens"])
    np.testing.assert_allclose(ours["residuals"], ref["residuals"],
                               rtol=1e-5)
    assert ours["token_accuracy"] == ref["token_accuracy"]
    assert ours["residuals"][-1] < ours["residuals"][0]


def test_cli_scenario_flags_and_audit_match_reference():
    args = ["--reduced", "--rounds", "2", "--clients", "5", "--batch", "2",
            "--seq-len", "16", "--n-perturb", "1", "--eval-every", "0",
            "--audit", "--audit-trials", "64", "--byzantine", "sign_flip",
            "--defense", "robust_decode", "--desync-frac", "0.25"]
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    ours = train.main(args + ["--device", "cpu"])
    buf, argv = io.StringIO(), sys.argv
    try:
        sys.argv = ["train"] + args
        with contextlib.redirect_stdout(buf):
            jtrain.main()
    finally:
        sys.argv = argv
    out = buf.getvalue()
    ref = json.loads(out[out.index("\n{") + 1:])
    assert ours["byzantine"] == ref["byzantine"]
    assert ours["desync"] == ref["desync"]
    got, want = dict(ours["audit"]), dict(ref["audit"])
    replay, jreplay = got.pop("seed_replay"), want.pop("seed_replay")
    assert got == want and got["dominated"]
    assert replay["per_client_exposed"] == jreplay["per_client_exposed"]
    for key in ("victim_rmse", "mean_rmse"):
        np.testing.assert_allclose(replay[key], jreplay[key], rtol=1e-4)
    assert ours["uplink_bits"] == ref["uplink_bits"]


def test_kernel_vjp_is_twice_differentiable():
    """The kernel wrapper's vjp, run with a float64 plain function in the
    kernel's place: gradgradcheck passes (its backward under create_graph
    recomputes on the saved inputs themselves), with an optional input
    absent and with two outputs."""
    g = torch.Generator().manual_seed(0)

    def plain(q, k, b):
        out = torch.softmax(q @ k.transpose(-1, -2), -1) @ k
        return out if b is None else (out, out * b)

    q, k, b = (torch.randn(2, 4, 3, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    vjp = ops._KernelWithPlainVjp.apply
    assert torch.autograd.gradgradcheck(
        lambda q, k: vjp(plain, plain, 3, q, k, None), (q, k))
    assert torch.autograd.gradgradcheck(
        lambda q, k, b: vjp(plain, plain, 3, q, k, b), (q, k, b))
