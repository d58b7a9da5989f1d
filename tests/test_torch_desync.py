"""Client desync (`repro_torch.runtime.desync`) against
`repro.runtime.desync`, and its hooks in the round, the trace and the run.

Tolerances:
- `sync_trace`, `frame_gain`, `control_rows` and `build_trace`'s desync
  rows (host numpy, the same generator draws): bitwise; the lagged leaf
  seeds against `repro.core.zo`'s: bitwise;
- `conventional_frame` on a tiny gradient tree: within 4 f32 ulps of
  max|leaf| (its frame gains are the same f32 cos and dot, summed in
  another order);
- `conventional_ici`: the interference normals are the reference's
  threefry draws, within C6's 4 ulps, so each noisy leaf is within 8 f32
  ulps of max|leaf| + max|noise term|;
- 3-round tiny-dense loop trajectories under desync (chained pAirZero,
  stale clients and phase error on) and under FO-SGD with desync's frame
  and interference, from the same weights: losses (and p̂) rtol 1e-4, as
  `test_torch_engine.py` holds trajectories against `repro`; the FO
  weights after 3 steps within 1e-5 of max|w|;
- port-only: an inert desync (fraction 0, phase_std 0) is the plain run
  bitwise; scan equals loop bitwise under desync.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.channel import RayleighFading  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import pairzero as jpairzero  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import fo as jfo  # noqa: E402
from repro.runtime import desync as jds  # noqa: E402
from repro_torch import channel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim, pairzero, zo  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import fo  # noqa: E402
from repro_torch.runtime import desync as ds  # noqa: E402
from test_torch_round import configs  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny runs are thousands of small ops: one intra-op thread
    runs them faster than a pool sharing the machine with the other test
    workers. The thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
MODELS = [dict(fraction=0.3, max_lag=3, phase_std=0.2, frame_symbols=1,
               seed=0),
          dict(fraction=0.0, max_lag=1, phase_std=0.5, frame_symbols=16,
               seed=7),
          dict(fraction=1.0, max_lag=5, phase_std=0.0, frame_symbols=3,
               seed=2**31 - 1)]
# stale clients from round 1 on, and a phase error
SCENARIO = dict(fraction=0.5, max_lag=2, phase_std=0.3, frame_symbols=4,
                seed=0)


@pytest.mark.parametrize("kw", MODELS)
def test_sync_trace_and_control_rows_match_reference(kw):
    ours, ref = ds.DesyncModel(**kw), jds.DesyncModel(**kw)
    for got, want in zip(ours.sync_trace(3, 17, 6), ref.sync_trace(3, 17, 6)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    theta = np.linspace(-2.0, 2.0, 41)
    np.testing.assert_array_equal(ds.frame_gain(theta, kw["frame_symbols"]),
                                  jds.frame_gain(theta, kw["frame_symbols"]))
    rows, stale = ds.control_rows(ours, 11, 3, 17, 6)
    jrows, jstale = jds.control_rows(ref, 11, 3, 17, 6)
    np.testing.assert_array_equal(stale, jstale)
    assert rows.keys() == jrows.keys()
    for key in rows:
        np.testing.assert_array_equal(rows[key], np.asarray(jrows[key]))
    cfg = base.DesyncConfig(**kw)
    assert ds.DesyncModel.from_config(cfg) == ours
    pz = base.PairZeroConfig(desync=cfg)
    assert ds.resolve(pz) == (ours if ours.active else None)


@pytest.mark.parametrize("bad", [dict(fraction=1.5), dict(max_lag=0),
                                 dict(phase_std=-0.1),
                                 dict(frame_symbols=0)])
def test_invalid_models_raise(bad):
    with pytest.raises(ValueError):
        ds.DesyncModel(**bad)
    with pytest.raises(ValueError):
        jds.DesyncModel(**bad)


def test_trace_rows_and_lagged_leaf_seeds():
    cfg, pz = configs(base, n_perturb=2)
    model = ds.DesyncModel(**SCENARIO)
    pz = dataclasses.replace(pz, desync=base.DesyncConfig(**SCENARIO))
    n_leaves = 9
    h = channel.RayleighFading().realize(0, 8, 5)
    sched = tp.resolve(pz).make_schedule(h, pz)
    trace = engine.build_trace(sched, pz, 2, 7, device="cpu",
                               n_leaves=n_leaves, desync=model)
    rows, stale = jds.control_rows(jds.DesyncModel(**SCENARIO), pz.seed, 2,
                                   7, 5)
    np.testing.assert_array_equal(trace.host_stale, stale)
    np.testing.assert_array_equal(trace.ctl["dsync_seed"], rows["dsync_seed"])
    for key in ("dsync_stale", "dsync_a", "dsync_frame"):
        np.testing.assert_array_equal(trace.ctl[key].numpy(), rows[key])
    want = np.asarray([[[jzo.leaf_seed(jzo.perturb_seed(s, j), i)
                         for i in range(n_leaves)] for j in range(2)]
                       for s in rows["dsync_seed"]], dtype=np.uint32)
    np.testing.assert_array_equal(
        trace.ctl["dsync_leaf_seeds"].numpy().view(np.uint32), want)
    assert "dsync_ici_keys" not in trace.ctl
    fo_trace = engine.build_trace(
        sched, pz, 2, 7, device="cpu", n_leaves=n_leaves, desync=model,
        transport=tp.FirstOrder())
    noise_key = jax.random.key(pz.seed ^ 0x5EED)
    for r, t in enumerate(range(2, 7)):
        keys = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(noise_key, t), ds.DESYNC_ICI_TAG), n_leaves)
        np.testing.assert_array_equal(
            fo_trace.ctl["dsync_ici_keys"][r].numpy(),
            np.asarray(jax.random.key_data(keys)))


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 2, 3)).astype(np.float32)]}


def _ctl(seed: int):
    rng = np.random.default_rng(seed)
    return {"mask": np.array([1, 1, 0, 1, 1], np.float32),
            "dsync_stale": np.array([0, 1, 0, 0, 1], np.float32),
            "dsync_a": np.cos(rng.normal(size=5) * 0.4).astype(np.float32),
            "dsync_frame": rng.uniform(0.2, 1.0, 5).astype(np.float32)}


@pytest.mark.parametrize("n", [1, 4, 7])
def test_conventional_frame_and_ici_match_reference(n):
    host, ctl = _tree(0), _ctl(1)
    jgrads = jax.tree_util.tree_map(jnp.asarray, host)
    jctl = {k: jnp.asarray(v) for k, v in ctl.items()}
    tctl = {k: torch.from_numpy(v) for k, v in ctl.items()}
    want = jax.tree_util.tree_leaves(jds.conventional_frame(jgrads, jctl, n))
    grads = params_from_numpy(host)
    leaves = [t for _, t in zo.flatten(grads)]
    assert ds.conventional_frame(grads, tctl, n) is grads    # in place
    for g, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=4 * EPS32 * np.abs(w).max())

    t = 5
    noise_key = jax.random.fold_in(jax.random.key(3 ^ 0x5EED), t)
    ref_leaves = jax.tree_util.tree_leaves(jds.conventional_ici(
        jgrads, jctl, noise_key, ref=jax.tree_util.tree_map(
            lambda x: 2 * x, jgrads)))
    keys = torch.from_numpy(ds.ici_keys(3, t, t + 1, 3)[0])
    rms = ds.ici_rms(zo.rebuild(grads, [2 * torch.from_numpy(x) for x in
                                        jax.tree_util.tree_leaves(host)]))
    ours = ds.conventional_ici(params_from_numpy(host), tctl, keys, rms)
    for (_, g), w, x in zip(zo.flatten(ours), ref_leaves,
                            jax.tree_util.tree_leaves(host)):
        w = np.asarray(w)
        tol = 8 * EPS32 * (np.abs(x).max() + np.abs(w - x).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def test_stale_payload_selects_per_client():
    fresh, stale = torch.arange(5.0), -torch.arange(5.0) - 1
    ctl = {"dsync_stale": torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0])}
    out = ds.stale_payload(fresh, stale, ctl)
    assert out.tolist() == [0.0, -2.0, 2.0, -4.0, 4.0]
    want = jds.stale_payload(jnp.arange(5.0), -jnp.arange(5.0) - 1,
                             {k: jnp.asarray(v.numpy())
                              for k, v in ctl.items()})
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _pipes():
    return (FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4,
                              seed=0),
            JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0))


def _weights(jcfg):
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def test_zo_trajectory_under_desync_matches_reference():
    """3 chained rounds with stale clients (each round's stale forward on
    the lagged seed) and a phase error in the superposition."""
    cfg, pz = configs(base, n_perturb=1)
    jcfg, jpz = configs(jbase, n_perturb=1)
    pz = dataclasses.replace(pz, desync=base.DesyncConfig(**SCENARIO))
    jpz = dataclasses.replace(jpz, desync=jbase.DesyncConfig(**SCENARIO))
    jparams, params = _weights(jcfg)
    pipe, jpipe = _pipes()
    stale = ds.DesyncModel(**SCENARIO).sync_trace(0, 3, 5)[0]
    assert stale[1:].sum() > 0            # the lagged forward is read
    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=3, engine="loop",
                      params=jparams, dtype=jnp.float32)
    res = fedsim.run(cfg, pz, pipe, rounds=3, params=params, device="cpu")
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(res.p_hats, ref.p_hats, rtol=1e-4,
                               atol=1e-4)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


def test_fo_sgd_under_desync_matches_reference():
    """3 FO-SGD steps with the frame gains (16 symbols) and the
    interference on the decoded gradient, the same control rows."""
    cfg, pz = configs(base, n_perturb=1)
    jcfg, jpz = configs(jbase, n_perturb=1)
    kw = dict(SCENARIO, frame_symbols=16)
    model, jmodel = ds.DesyncModel(**kw), jds.DesyncModel(**kw)
    pz = dataclasses.replace(pz, transport=base.TransportConfig(
        mechanism="fo"))
    jpz = dataclasses.replace(jpz, transport=jbase.TransportConfig(
        mechanism="fo"))
    jparams, params = _weights(jcfg)
    pipe, jpipe = _pipes()
    h = RayleighFading().realize(pz.seed ^ 0xC4A7, 8, 5)
    jsched = jtp.resolve(jpz).make_schedule(h, jpz)
    sched = tp.resolve(pz).make_schedule(h, pz)
    jtrace = jeng.build_trace(jsched, jpz, 0, 3, desync=jmodel)
    n_leaves = len(zo.flatten(params))
    trace = engine.build_trace(sched, pz, 0, 3, device="cpu",
                               n_leaves=n_leaves, desync=model,
                               transport=tp.FirstOrder())
    jstep = jax.jit(jpairzero.make_fo_step(jcfg, jfo.SGD(lr=0.5),
                                           desync=jmodel))
    step = pairzero.make_fo_step(cfg, fo.SGD(lr=0.5), desync=model)
    jstate, state = (), ()
    for r in range(3):
        b = jpipe.batch(r)
        jparams, jstate, jm = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()},
            {k: v[r] for k, v in jtrace.ctl.items()})
        tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                  else v) for k, v in pipe.batch(r).items()
              if k != "labels"}
        (params, state), m = step((params, state), tb,
                                  {k: v[r] for k, v in trace.ctl.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    for (path, g), w in zip(zo.flatten(params),
                            jax.tree_util.tree_leaves(jparams)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=path)


def _run(pz, **kw):
    cfg, _ = configs(base, n_perturb=1)
    jcfg = configs(jbase, n_perturb=1)[0]
    params = _weights(jcfg)[1]
    return fedsim.run(cfg, pz, _pipes()[0], 3, params=params, device="cpu",
                      **kw)


def test_inert_desync_is_the_plain_run_and_scan_equals_loop():
    _, pz = configs(base, n_perturb=1)
    plain = _run(pz)
    inert = _run(dataclasses.replace(pz, desync=base.DesyncConfig(
        fraction=0.0, phase_std=0.0, max_lag=3)))
    explicit = _run(pz, desync=ds.DesyncModel())
    for other in (inert, explicit):
        assert other.losses == plain.losses and other.p_hats == plain.p_hats
        for (path, x), (_, y) in zip(zo.flatten(other.params),
                                     zo.flatten(plain.params)):
            assert torch.equal(x, y), path
    on = dataclasses.replace(pz, desync=base.DesyncConfig(**SCENARIO))
    loop, scan = _run(on), _run(on, engine="scan", chunk_rounds=2)
    assert loop.losses != plain.losses
    assert scan.losses == loop.losses and scan.p_hats == loop.p_hats
    for (path, x), (_, y) in zip(zo.flatten(scan.params),
                                 zo.flatten(loop.params)):
        assert torch.equal(x, y), path
