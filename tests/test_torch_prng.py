"""The port's threefry draws (`repro_torch.prng`) against jax's, and what
rests on them: the control trace's OTA normals and digital uniforms, the
weight init of the three families, and a same-seed run of each package
with nothing injected.

Tolerances: keys, bits and uniforms bitwise; normals within NORMAL_ULPS
f32 ulps of `jax.random.normal` (the port's `erf_inv` is XLA's polynomial
with each multiply-add rounded once, but takes log1p in f64, which XLA's
f32 log1p misses by an ulp or two; 3 ulps is the most seen, over 2^20
draws); init leaves within NORMAL_ULPS + 1 (the scale's multiply rounds
once more); the 4-round runs' losses rtol 1e-4 (f32 differences compound
through the updates, as in `test_torch_slice.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base, get_arch  # noqa: E402
from repro_torch.core import engine, fedsim, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from test_torch_round import configs, jax_noise_rows  # noqa: E402

NORMAL_ULPS = 4
SEEDS = (0, 1, 2**31 - 1, np.uint32(3_000_000_007))


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bitwise(seed):
    jk, k = jax.random.key(seed), prng.key(seed)
    assert np.array_equal(prng.key_data(k), _data(jk))
    assert prng.key_data(k).dtype == np.uint32
    for d in (0, 1, 7, 2**31, 2**32 - 1):
        assert np.array_equal(prng.key_data(prng.fold_in(k, d)),
                              _data(jax.random.fold_in(jk, d)))
    for num in (1, 2, 3, 5):
        assert np.array_equal(prng.key_data(prng.split(k, num)),
                              _data(jax.random.split(jk, num)))
    # batched: fold_in over a vector of data, split of a batch of keys
    data = np.arange(6, dtype=np.uint32) * 977
    words = torch.from_numpy(data.astype(np.int64))
    assert np.array_equal(
        prng.key_data(prng.fold_in(k, words)),
        _data(jax.vmap(lambda d: jax.random.fold_in(jk, d))(data)))
    keys = prng.split(k, 4)
    assert np.array_equal(prng.key_data(prng.split(keys, 3)),
                          _data(jax.vmap(lambda kk: jax.random.split(kk, 3))(
                              jax.random.split(jk, 4))))
    assert torch.equal(prng.wrap_key_data(prng.key_data(keys)), keys)


@pytest.mark.parametrize("n", [1, 2, 11, 64])
def test_threefry_2x32_bitwise(n):
    rng = np.random.default_rng(n)
    count = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k1, k2 = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    ours = prng.threefry_2x32((k1, k2), count).numpy().astype(np.uint32)
    ref = np.asarray(jprng.threefry_2x32((jnp.uint32(k1), jnp.uint32(k2)),
                                         jnp.asarray(count)))
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (2, 3, 4)])
def test_bits_and_uniform_bitwise(seed, shape):
    jk, k = jax.random.key(seed), prng.key(seed)
    assert np.array_equal(prng.random_bits(k, shape).numpy().astype(
        np.uint32), np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    ours = prng.uniform(k, shape).numpy()
    ref = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    assert ours.shape == ref.shape and _ulps(ours, ref) == 0
    lo, hi = -0.7, 2.5
    assert _ulps(prng.uniform(k, shape, lo, hi),
                 jax.random.uniform(jk, shape, jnp.float32, lo, hi)) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps(seed):
    jk, k = jax.random.key(seed), prng.key(seed)
    for shape in ((), (5,), (3, 7), (2, 3, 4), (1 << 16,)):
        ours = prng.normal(k, shape).numpy()
        ref = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        assert ours.shape == ref.shape
        assert _ulps(ours, ref) <= NORMAL_ULPS, shape


def test_erf_inv_at_the_ends():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    ours = prng.erf_inv(x).numpy()
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(ours[0]) and np.isposinf(ours[1]) and ours[2] == 0
    assert _ulps(ours[2:], ref[2:]) <= NORMAL_ULPS


def test_sliced_draws_equal_one_draw(monkeypatch):
    """Element i depends only on the key and i: a draw taken in slices
    (here 1000 elements at a time, over a batch of 3 keys) has the bits of
    one whole draw."""
    keys = prng.split(prng.key(5), 3)
    whole = {f: getattr(prng, f)(keys, (37, 101))
             for f in ("random_bits", "uniform", "normal")}
    monkeypatch.setattr(prng, "SLICE", 1000)
    for f, want in whole.items():
        assert torch.equal(getattr(prng, f)(keys, (37, 101)), want), f


def test_batched_keys_equal_vmap():
    jkeys = jax.random.split(jax.random.key(9), 4)
    keys = prng.wrap_key_data(_data(jkeys))
    ours = prng.normal(keys, (6, 5)).numpy()
    ref = np.asarray(jax.vmap(lambda kk: jax.random.normal(
        kk, (6, 5), jnp.float32))(jkeys))
    assert _ulps(ours, ref) <= NORMAL_ULPS
    assert _ulps(prng.uniform(keys, (6, 5)), jax.vmap(
        lambda kk: jax.random.uniform(kk, (6, 5)))(jkeys)) == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_control_rows_are_the_reference_draws(seed):
    """`noise_rows` gives the normals `repro.core.ota.superpose` draws from
    the round's own `ctl["noise_bits"]`, and `uniform_rows` the uniforms
    `stochastic_quantize` draws from the same round keys."""
    from repro.core import pairzero as jpairzero
    from repro.channel import RayleighFading
    from repro.core import transport as jtp
    _, jpz = configs(jbase, n_perturb=3)
    sched = jtp.resolve(jpz).make_schedule(
        RayleighFading().realize(1, 8, 5), jpz)
    noise = engine.noise_rows(seed, 2, 6, 3, 5)
    uni = engine.uniform_rows(seed, 2, 6, 3, 5)
    assert noise.shape == (4, 3, 6) and uni.shape == (4, 3, 5)
    for r, t in enumerate(range(2, 6)):
        bits = jpairzero.make_control(t, sched, seed, 5)["noise_bits"]
        assert _ulps(noise[r], jax_noise_rows(bits, 3, 5)) <= NORMAL_ULPS
        key = jax.random.wrap_key_data(jnp.asarray(bits))
        for j in range(3):
            ref = jax.random.uniform(jax.random.fold_in(key, j), (5,))
            assert _ulps(uni[r, j], ref) == 0


def _family(name):
    if name == "dense":
        return configs(base)[0], configs(jbase)[0]
    arch, kw = {"ssm": ("mamba2-370m", {}),
                "hybrid": ("recurrentgemma-2b", dict(n_layers=5)),
                "hybrid-tail": ("recurrentgemma-2b", {})}[name]
    return get_arch(arch).reduced(**kw), jreg.get_arch(arch).reduced(**kw)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid",
                                    "hybrid-tail"])
def test_init_params_match_reference_leaf_for_leaf(family):
    """`registry.init_params(cfg, prng.key(s))` draws every leaf as
    `repro.models.registry.init_params(jax.random.key(s), cfg)` does:
    same leaves, order and shapes, values within the normal's ulps (one
    more for the scale's multiply). `hybrid-tail` has no full rra group
    (its groups have a leading dim of 0) and a tail of two."""
    cfg, jcfg = _family(family)
    for s in (0, 11):
        ours = zo.flatten(registry.init_params(cfg, prng.key(s), "cpu"))
        ref = jax.tree_util.tree_flatten_with_path(
            jreg.init_params(jax.random.key(s), jcfg))[0]
        assert len(ours) == len(ref)
        for (path, t), (_, leaf) in zip(ours, ref):
            leaf = np.asarray(leaf)
            assert tuple(t.shape) == leaf.shape, path
            assert _ulps(t.numpy(), leaf) <= NORMAL_ULPS + 1, path


def test_same_seed_runs_match_reference_with_nothing_injected():
    """A 4-round run of each package from the same seed, with neither the
    weights nor the OTA noise passed across: the port draws both as the
    reference does."""
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    ref = jfedsim.run(jcfg, jpz, JPipe("sst2", JSpec("sst2", 64, 24), 5, 4,
                                       seed=0), rounds=4, engine="loop",
                      dtype=jnp.float32)
    res = fedsim.run(cfg, pz, FederatedPipeline(
        "sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0), rounds=4,
        device="cpu")
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits
