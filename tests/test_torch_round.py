"""One pAirZero round of the port against `repro`'s round body, from the
same weights, batch, control block and OTA noise.

The reference draws its noise with jax.random from the round's noise key;
the test computes those exact normals from `repro`'s own control block and
puts them in the port's `noise` rows, so both packages see the same draws.

Tolerances: losses rtol 1e-5 (f32 summation orders differ); p_k and p̂
then differ by at most 2·ΔL/(2μ), so their atol is derived from the loss
tolerance that way; the new weights atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.channel import RayleighFading  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import pairzero as jpairzero  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import pairzero, zo  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def jax_noise_rows(noise_bits, n_perturb: int, k: int) -> np.ndarray:
    """[n_perturb, K+1]: the normals `repro.core.ota.superpose` draws for
    each perturbation direction j of the round with this noise key."""
    key = jax.random.wrap_key_data(jnp.asarray(noise_bits))
    rows = []
    for j in range(n_perturb):
        nk_key, z_key = jax.random.split(jax.random.fold_in(key, j))
        rows.append(np.concatenate([
            np.asarray(jax.random.normal(nk_key, (k,), jnp.float32)),
            np.asarray(jax.random.normal(z_key, (), jnp.float32))[None]]))
    return np.stack(rows).astype(np.float32)


def configs(mod, n_perturb=2, dual_mode="sequential", lr=5e-3):
    tiny = mod.ModelConfig(name="tiny", family="dense", n_layers=2,
                           d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                           vocab_size=64, head_dim=16)
    pz = mod.PairZeroConfig(
        n_clients=5, rounds=8,
        zo=mod.ZOConfig(mu=1e-3, lr=lr, clip_gamma=5.0, n_perturb=n_perturb,
                        dual_mode=dual_mode),
        channel=mod.ChannelConfig(n0=1.0, power=100.0),
        dp=mod.DPConfig(epsilon=5.0, delta=0.01),
        transport=mod.TransportConfig(), seed=0)
    return tiny, pz


def _batch(k=5, b=4, s=24, vocab=64, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.zeros((k, b, s), np.float32)
    mask[..., -4:] = 1.0
    return {"tokens": rng.integers(0, vocab, (k, b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (k, b, s)).astype(np.int32),
            "mask": mask}


@pytest.mark.parametrize("dual_mode", ["sequential", "fresh"])
def test_one_round_matches_reference(dual_mode):
    cfg, pz = configs(base, dual_mode=dual_mode)
    jcfg, jpz = configs(jbase, dual_mode=dual_mode)
    h = RayleighFading().realize(0 ^ 0xC4A7, pz.rounds, 5)
    sched = jtp.resolve(jpz).make_schedule(h, jpz)
    t = 2
    jctl = jpairzero.make_control(t, sched, jpz.seed, 5)
    jparams = jreg.init_params(jax.random.key(1), jcfg)
    batch = _batch()

    jstep = jax.jit(jpairzero.make_zo_step(jcfg, jpz))
    jnew, jm = jstep(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                     jctl)

    cpu = torch.device("cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ctl = pairzero.make_control(t, sched, pz.seed, 5, pz.zo.n_perturb, cpu,
                                n_leaves=len(zo.flatten(params)))
    assert ctl["seed"] == int(jctl["seed"])
    ctl["noise"] = torch.from_numpy(
        jax_noise_rows(jctl["noise_bits"], pz.zo.n_perturb, 5))
    tbatch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                  else v) for k, v in batch.items()}
    new, m = pairzero.make_zo_step(cfg, pz)(params, tbatch, ctl)

    loss = float(jm["loss"])
    assert float(m["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    p_atol = 2 * LOSS_RTOL * abs(loss) / (2 * pz.zo.mu)
    np.testing.assert_allclose(m["p_clients"].numpy(),
                               np.asarray(jm["p_clients"]), rtol=0,
                               atol=p_atol)
    assert float(m["p_hat"]) == pytest.approx(float(jm["p_hat"]), abs=p_atol)
    assert float(m["k_eff"]) == float(jm["k_eff"])
    jleaves = dict((".".join(str(k.key) for k in path), np.asarray(leaf))
                   for path, leaf in
                   jax.tree_util.tree_flatten_with_path(jnew)[0])
    for path, leaf in zo.flatten(new):
        np.testing.assert_allclose(leaf.numpy(), jleaves[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)


def test_chained_walk_is_in_place_and_restores():
    """Chained mode updates the very tensors it was given (one θ in
    memory): w → w+μz → w−μz, and a final (μ − 0)·z axpy restores w to
    within the f32 rounding of the three axpys."""
    cfg, pz = configs(base)
    from repro_torch import prng
    from repro_torch.models import registry
    params = registry.init_params(cfg, prng.key(0), torch.device("cpu"))
    before = {p: t.clone() for p, t in zo.flatten(params)}
    ptrs = {p: t.data_ptr() for p, t in zo.flatten(params)}
    calls = []

    def loss_fn(p):
        calls.append({k: t.clone() for k, t in zo.flatten(p)})
        return torch.zeros(5)

    seeds = zo.seed_row(1234, len(ptrs))
    _, _, at = zo.dual_forward(loss_fn, params, seeds, 1e-3, mode="chained")
    assert at is params
    assert {p: t.data_ptr() for p, t in zo.flatten(params)} == ptrs
    zo.apply_update(at, seeds, torch.tensor(0.0), 0.1, 1e-3, mode="chained")
    for path, t in zo.flatten(params):
        assert t.data_ptr() == ptrs[path]
        np.testing.assert_allclose(t.numpy(), before[path].numpy(), rtol=0,
                                   atol=1e-6)
        assert not torch.equal(calls[0][path], calls[1][path])
