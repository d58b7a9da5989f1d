"""Byzantine behaviors and defenses (`repro_torch.byzantine`) against
`repro.byzantine`, with the threefry draws they need.

Tolerances:
- `prng.permutation` (n = 5, 40 and 2000; 2000 takes two sort rounds)
  and `prng.bernoulli` against jax: bitwise;
- `client_mask`, the clip's schedule (`defended_config`, the Theorem-3
  solve and its DP costs), `uplink_bits_total` under each defense:
  bitwise / equal;
- each behavior's `apply_behavior` on the same payload and round key:
  bitwise, but gaussian_noise, whose normals are the reference's threefry
  draws within C6's 4 ulps (the jammed entries within 4 ulps of the
  noise term);
- each defense's `aggregate` under analog, sign and digital on the same
  payload, control block and round key: the sub-slot assignment bitwise;
  the estimate within 1e-5 of max(1, |ref|) (sums in another order over
  normals within 4 ulps, divided by c; digital's dither is bitwise);
- a 3-round tiny-dense loop trajectory under sign_flip + robust_decode
  from the same weights: losses and p̂ rtol 1e-4, as
  `test_torch_engine.py` holds trajectories against `repro`;
- port-only: behavior "none", fraction 0 and defense "none" are the plain
  run bitwise; FO with a behavior or defense raises ValueError.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import byzantine as jbyz  # noqa: E402
from repro.channel import RayleighFading  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import power_control as jpc  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.byzantine import defenses as jdef  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import byzantine as byz  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim, zo  # noqa: E402
from repro_torch.core import power_control as pc  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
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


@pytest.mark.parametrize("n", [5, 40, 2000])
def test_permutation_and_bernoulli_are_jax_bitwise(n):
    for seed in (0, 1, 2**31 - 1):
        jk = jax.random.fold_in(jax.random.key(seed), n)
        k = prng.fold_in(prng.key(seed), n)
        np.testing.assert_array_equal(prng.permutation(k, n).numpy(),
                                      np.asarray(jax.random.permutation(
                                          jk, n)))
        for p in (0.5, 0.1):
            assert bool(prng.bernoulli(k, p)) == bool(
                jax.random.bernoulli(jk, p))
    keys = prng.fold_in(prng.key(3), torch.arange(16))
    flips = prng.bernoulli(keys).numpy()
    want = [bool(jax.random.bernoulli(jax.random.fold_in(
        jax.random.key(3), i))) for i in range(16)]
    assert flips.tolist() == want and 0 < sum(want) < 16


@pytest.mark.parametrize("frac,seed,k", [(0.25, 0, 5), (0.5, 3, 8),
                                         (0.0, 1, 5), (1.0, 2, 4)])
def test_client_mask_matches_reference(frac, seed, k):
    ours = byz.SignFlip(fraction=frac, seed=seed).client_mask(k)
    ref = jbyz.SignFlip(fraction=frac, seed=seed).client_mask(k)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype


def _pz(mod, **bz):
    _, pz = configs(mod, n_perturb=2)
    return dataclasses.replace(pz, byzantine=mod.ByzantineConfig(**bz))


def _one(pz):
    """The config with one perturbation direction (the runs' cost)."""
    return dataclasses.replace(pz, zo=dataclasses.replace(pz.zo,
                                                          n_perturb=1))


def test_clip_schedule_and_costs_match_reference():
    pz, jpz = (_pz(m, defense="clip", clip_factor=0.3) for m in (base,
                                                                 jbase))
    d, jd = byz.resolve_defense(pz), jbyz.resolve_defense(jpz)
    assert d.clip == jd.clip == 0.3 * 5.0
    assert pc.defended_config(pz, d.clip).zo.clip_gamma == \
        jpc.defended_config(jpz, jd.clip).zo.clip_gamma
    assert pc.defended_config(pz, 9.0) is pz
    h = RayleighFading().realize(5, 16, K)
    for transport, jtransport in ((tp.AnalogOTA(), jtp.AnalogOTA()),
                                  (tp.SignOTA(), jtp.SignOTA())):
        sched = d.make_schedule(transport, h, pz)
        jsched = jd.make_schedule(jtransport, h, jpz)
        np.testing.assert_array_equal(sched.c, jsched.c)
        np.testing.assert_array_equal(
            d.round_dp_costs(transport, sched, 2, 9, pz),
            jd.round_dp_costs(jtransport, jsched, 2, 9, jpz))
        assert d.charges_privacy(transport, sched, pz) == \
            jd.charges_privacy(jtransport, jsched, jpz)
        assert transport.canary_payload(d.audited_pz(pz)) == \
            jtransport.canary_payload(jd.audited_pz(jpz))


@pytest.mark.parametrize("name", ["clip", "robust_decode", "reweight"])
def test_uplink_bits_under_each_defense(name):
    pz, jpz = (_pz(m, defense=name, groups=3) for m in (base, jbase))
    d, jd = byz.resolve_defense(pz), jbyz.resolve_defense(jpz)
    assert d.resource_blocks() == jd.resource_blocks()
    for mech in ("analog", "sign", "digital", "smart_digital", "fo"):
        t = tp.get(mech).from_config(base.TransportConfig(mechanism=mech),
                                     pz)
        jt = jtp.get(mech).from_config(jbase.TransportConfig(
            mechanism=mech), jpz)
        assert tp.uplink_bits_total(t, d, pz, 1000, 13.0, 4) == \
            jtp.uplink_bits_total(jt, jd, jpz, 1000, 13.0, 4)
    assert tp.uplink_bits_total(t, None, pz, 1000, 13.0, 4) == \
        jtp.uplink_bits_total(jt, None, jpz, 1000, 13.0, 4)


def _round(seed=0, t=3, j=1):
    """A payload, control block and round key (direction j of round t)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5, 5, K).astype(np.float32)
    host = {"c": np.float32(0.7), "n0": np.float32(1.0),
            "sigma": rng.uniform(0, 0.5, K).astype(np.float32),
            "mask": np.array([1, 1, 0, 1, 1], np.float32),
            "g": np.cos(rng.normal(size=K) * 0.1).astype(np.float32)}
    jkey = jax.random.fold_in(jax.random.fold_in(
        jax.random.key(seed ^ 0x5EED), t), j)
    key = engine.direction_keys(seed, t, t + 1, j + 1)[0, j]
    return p, host, jkey, key


@pytest.mark.parametrize("name,scale", [("sign_flip", 3.0),
                                        ("scaled_poison", 2.5),
                                        ("gaussian_noise", 3.0),
                                        ("colluding_cohort", 3.0)])
def test_behaviors_match_reference(name, scale):
    pz, jpz = (_pz(m, behavior=name, fraction=0.4, scale=scale)
               for m in (base, jbase))
    b, jb = byz.resolve_behavior(pz), jbyz.resolve_behavior(jpz)
    for t in range(6):                      # both colluder signs occur
        p, host, jkey, key = _round(t=t)
        mask = b.client_mask(K)
        want = np.asarray(jbyz.apply_behavior(
            jb, jnp.asarray(p), {"byz": jnp.asarray(mask)}, jkey))
        rows = b.draw_rows(prng.fold_in(key, byz.BYZ_KEY_TAG), K)
        ctl = {"byz": torch.from_numpy(mask),
               **{k: torch.from_numpy(v) for k, v in rows.items()}}
        got = byz.apply_behavior(b, torch.from_numpy(p), ctl).numpy()
        np.testing.assert_array_equal(got[mask == 0], p[mask == 0])
        if name == "gaussian_noise":
            np.testing.assert_allclose(
                got, want, rtol=0, atol=4 * EPS32 * np.abs(want - p).max())
        else:
            np.testing.assert_array_equal(got, want)


def _transports(mech):
    t = tp.get(mech).from_config(base.TransportConfig(mechanism=mech),
                                 _pz(base))
    jt = jtp.get(mech).from_config(jbase.TransportConfig(mechanism=mech),
                                   _pz(jbase))
    return t, jt


@pytest.mark.parametrize("name", ["robust_decode", "reweight", "clip"])
@pytest.mark.parametrize("mech", ["analog", "sign", "digital"])
def test_defense_aggregates_match_reference(name, mech):
    d = byz.get_defense(name)() if name == "clip" else \
        byz.get_defense(name)(groups=3)
    jd = jbyz.get_defense(name)() if name == "clip" else \
        jbyz.get_defense(name)(groups=3)
    t, jt = _transports(mech)
    for seed in range(4):
        p, host, jkey, key = _round(seed=seed)
        jctl = {k: jnp.asarray(v) for k, v in host.items()}
        want = float(jd.aggregate(jt, jd.transmit(jnp.asarray(p), jctl),
                                  jctl, jkey))
        ctl = {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}
        ctl.update({k: v[0] for k, v in
                    tp.key_draws(t.draws, key[None], K).items()})
        rows = d.draw_rows(t, key[None], K)
        ctl.update({k: torch.from_numpy(v)[0] for k, v in rows.items()})
        if name != "clip":
            np.testing.assert_array_equal(
                rows["group_of"][0],
                np.asarray(jdef._group_assignment(jkey, K, 3)))
        got = float(d.aggregate(t, d.transmit(torch.from_numpy(p), ctl),
                                ctl))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def _pipes():
    return (FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4,
                              seed=0),
            JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0))


def _weights():
    jparams = jreg.init_params(jax.random.key(0), configs(jbase)[0])
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def test_attacked_and_defended_trajectory_matches_reference():
    bz = dict(behavior="sign_flip", fraction=0.4, defense="robust_decode",
              groups=2)
    cfg, jcfg = configs(base)[0], configs(jbase)[0]
    pz, jpz = _one(_pz(base, **bz)), _one(_pz(jbase, **bz))
    jparams, params = _weights()
    pipe, jpipe = _pipes()
    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=3, engine="loop",
                      params=jparams, dtype=jnp.float32)
    res = fedsim.run(cfg, pz, pipe, rounds=3, params=params, device="cpu")
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(res.p_hats, ref.p_hats, rtol=1e-4, atol=1e-4)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


def _run(pz, **kw):
    return fedsim.run(configs(base)[0], pz, _pipes()[0], 3,
                      params=_weights()[1], device="cpu", **kw)


def test_neutral_scenarios_are_the_plain_run():
    _, pz = configs(base, n_perturb=1)
    plain = _run(pz)
    for bz in (dict(behavior="none", fraction=0.5),
               dict(behavior="sign_flip", fraction=0.0)):
        other = _run(_one(_pz(base, **bz)))
        assert other.losses == plain.losses and other.p_hats == plain.p_hats
        assert other.uplink_bits == plain.uplink_bits
        for (path, x), (_, y) in zip(zo.flatten(other.params),
                                     zo.flatten(plain.params)):
            assert torch.equal(x, y), path
    attacked = _one(_pz(base, behavior="gaussian_noise", fraction=0.4,
                        defense="reweight", groups=2))
    scan = _run(attacked, engine="scan", chunk_rounds=2)
    loop = _run(attacked)
    assert scan.losses == loop.losses and scan.p_hats == loop.p_hats
    assert loop.losses != plain.losses


@pytest.mark.parametrize("bz", [dict(behavior="sign_flip", fraction=0.4),
                                dict(defense="clip")])
def test_fo_with_a_behavior_or_defense_raises(bz):
    pz = dataclasses.replace(_pz(base, **bz), transport=base.TransportConfig(
        mechanism="fo"))
    with pytest.raises(ValueError, match="FO baseline"):
        fedsim.Experiment(configs(base)[0], pz, _pipes()[0], 1,
                          device="cpu")
