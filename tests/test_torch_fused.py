"""The port's fused dual forward (`fused_perturbation=True`) against `repro`.

Tolerances:
- counters are exact integers, compared bitwise; the z values they feed are
  held within 3 ulp of |z|·|eps| (XLA's and PyTorch's CPU log/cos each
  round on their own, see test_torch_stream);
- within the port, resolve, the identity probe and fused-vs-fresh are
  bitwise: the same f32 operations on the same values;
- perturbed_matmul against `repro`'s Pallas kernel (interpret mode) and its
  XLA impl: rtol 1e-5 with atol 1e-5 · max|ref| (f32 sums in another
  order; outputs near zero come from cancellation, so a relative bound
  alone does not hold there — the card's check uses the same 1e-5 ·
  max|ref|);
- dual-forward losses rtol 1e-5; the 4-round trajectory rtol 1e-4 (f32
  differences compound through the updates).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.perturbed_matmul import perturbed_matmul_pallas  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base, get_arch  # noqa: E402
from repro_torch.core import engine, fedsim, pairzero, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import perturbed_matmul as pmm  # noqa: E402
from repro_torch.kernels import seeded_axpy as sa  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs  # noqa: E402
from test_torch_slice import jax_trace_noise  # noqa: E402

Z_ULPS = 3
SEED = 0x5EED5
EPS = 1e-3


def _ulps(a, b) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _jtag(w: np.ndarray, seed=SEED, eps=EPS):
    return jzo.tag_perturbed({"w": jnp.asarray(w)}, seed, eps)["w"]


def _tag(w: np.ndarray, seed=SEED, eps=EPS):
    return zo.tag_perturbed({"w": torch.from_numpy(w)}, zo.seed_row(seed, 1),
                            eps)["w"]


def _jslice(pp, layer: int):
    """One layer of a tagged stacked leaf, as `lax.scan` slices it."""
    return jax.tree_util.tree_map(lambda a: a[layer], pp)


def _jcounters(pp) -> np.ndarray:
    """`repro`'s counter array for a (sliced) tagged leaf: off + flat iota."""
    return np.asarray(pp.off + jops._flat_iota(pp.w.shape)).astype(np.int64)


@pytest.mark.parametrize("shape,layer", [((3, 40, 24), 2), ((4, 64), 3),
                                         ((5, 7, 9, 6), 1)])
def test_layer_slice_counters_and_z_match_reference(shape, layer):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jpp, pp = _jslice(_jtag(w), layer), _tag(w)[layer]
    assert pp.off == int(jpp.off) == layer * int(np.prod(shape[1:]))
    counters = sa.flat_counters(pp.w.shape, pp.off)
    np.testing.assert_array_equal(counters.numpy(), _jcounters(jpp))
    z_ref = np.asarray(jops.perturbed_z(jpp))
    assert _ulps(ops.perturbed_z(pp).numpy(), z_ref).max() <= Z_ULPS


def test_one_dim_leaf_counters_start_at_zero():
    """A 1-D leaf (final_norm.g) is tagged whole: counters 0..D−1."""
    w = np.ones(48, np.float32)
    jpp, pp = _jtag(w), _tag(w)
    assert pp.off == 0
    counters = sa.flat_counters(pp.w.shape, pp.off)
    np.testing.assert_array_equal(counters.numpy(), np.arange(48))
    # repro keeps one counter per leading index of the unsliced leaf, and
    # perturbed_z's 1-D branch reads them as the element counters
    np.testing.assert_array_equal(np.asarray(jpp.off).astype(np.int64),
                                  counters.numpy())
    assert _ulps(ops.perturbed_z(pp).numpy(),
                 np.asarray(jops.perturbed_z(jpp))).max() <= Z_ULPS


def test_gathered_row_counters_and_values_match_reference():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((97, 24)).astype(np.float32)
    tokens = rng.integers(0, 97, size=(3, 11))
    jpp, pp = _jtag(w), _tag(w)
    # repro: row v of the tagged table starts at off[v]; column j adds j
    want = (np.asarray(jnp.take(jpp.off, jnp.asarray(tokens), axis=0)
                       ).astype(np.int64)[..., None] + np.arange(24))
    got = sa.gather_counters(torch.from_numpy(tokens), 24, pp.off)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = ops.perturbed_gather(pp, torch.from_numpy(tokens)).numpy()
    ref = np.asarray(jops.perturbed_gather(jpp, jnp.asarray(tokens)))
    np.testing.assert_allclose(rows, ref, rtol=0,
                               atol=EPS * 6 * Z_ULPS * 2**-23 + 2**-22)
    # each gathered row carries the bits its row has in the whole table
    table = ops.resolve(pp).numpy()
    np.testing.assert_array_equal(rows, table[tokens])


@pytest.mark.parametrize("eps", [EPS, -0.25])
def test_resolve_bitwise_within_port_and_close_to_reference(eps):
    w = np.random.default_rng(2).standard_normal((3, 30, 20)).astype(
        np.float32)
    whole = sa.seeded_axpy_plain(torch.from_numpy(w), zo.leaf_seed(SEED, 0),
                                 torch.tensor(eps, dtype=torch.float32))
    for layer in range(3):
        got = ops.resolve(_tag(w, eps=eps)[layer])
        assert torch.equal(got, whole[layer])
        ref = np.asarray(jops.resolve(_jslice(_jtag(w, eps=eps), layer)))
        z = np.abs(ops.perturbed_z(_tag(w)[layer]).numpy())
        err = np.abs(got.numpy() - ref)
        # 3 ulp of z·|eps|, plus the rounding of the sum
        tol = Z_ULPS * 2.0**-23 * z * abs(eps) \
            + 2.0**-24 * np.abs(ref) * 2
        assert np.all(err <= tol + 1e-30), float((err - tol).max())


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("m,k,n,layer", [(37, 200, 300, 1), (5, 96, 64, 2),
                                         (130, 33, 129, 0)])
def test_perturbed_matmul_plain_matches_reference(impl, m, k, n, layer):
    rng = np.random.default_rng(m + k + n)
    w = rng.standard_normal((3, k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jpp, pp = _jslice(_jtag(w), layer), _tag(w)[layer]
    assert pp.off != 0 or layer == 0
    if impl == "xla":
        ref = np.asarray(jops.perturbed_matmul(jnp.asarray(x), jpp,
                                               impl="xla"))
    else:
        ref = np.asarray(perturbed_matmul_pallas(
            jnp.asarray(x), jpp.w, jpp.seed, jpp.off, jpp.eps,
            interpret=True))
    got = pmm.perturbed_matmul_plain(torch.from_numpy(x), pp.w, pp.seed,
                                     pp.off, pp.scale()).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # the dispatching entry point takes the plain version on the CPU
    assert torch.equal(ops.perturbed_matmul(torch.from_numpy(x), pp),
                       torch.from_numpy(got))


@pytest.mark.parametrize("k,n,off", [(64, 48, 0), (40, 72, 2**32 - 100)])
def test_identity_probe_bitwise_within_port(k, n, off):
    """x = I returns w + eps·z exactly as seeded_axpy writes it, counters
    wrapping past 2³² included."""
    w = torch.from_numpy(
        np.random.default_rng(3).standard_normal((k, n)).astype(np.float32))
    eps = torch.tensor(0.5, dtype=torch.float32)
    out = pmm.perturbed_matmul_plain(torch.eye(k), w, 77, off, eps)
    assert torch.equal(out, sa.seeded_axpy_plain(w, 77, eps, off))


def _batch(vocab, k=5, b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(k, b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(k, b, s)).astype(np.int32),
            "mask": (rng.random((k, b, s)) < 0.5).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _jcfg(cfg):
    return jbase.ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "head_dim")})


def _models():
    tiny, _ = configs(base)
    return {"tiny": tiny, "opt-125m.reduced": get_arch("opt-125m").reduced()}


@pytest.mark.parametrize("which", ["tiny", "opt-125m.reduced"])
def test_fused_dual_forward_matches_fresh_and_reference(which):
    cfg = _models()[which]
    jcfg = _jcfg(cfg)
    jparams = jreg.init_params(jax.random.key(4), jcfg)
    batch = _batch(cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlp, jlm, _ = jzo.dual_forward(
        lambda p: jtf.loss_per_client(p, jcfg, jbatch, impl="xla"),
        jparams, SEED, EPS, mode="fused")

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    before = {p: t.clone() for p, t in zo.flatten(params)}
    tb = _torch_batch(batch)
    loss = lambda p: transformer.loss_per_client(p, cfg, tb)  # noqa: E731
    seeds = zo.seed_row(SEED, len(zo.flatten(params)))
    lp, lm, at = zo.dual_forward(loss, params, seeds, EPS, mode="fused")
    assert at is params
    for path, t in zo.flatten(params):       # θ is never written
        assert torch.equal(t, before[path]), path
    flp, flm, _ = zo.dual_forward(loss, params, seeds, EPS, mode="fresh")
    assert torch.equal(lp, flp) and torch.equal(lm, flm)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jlm), rtol=1e-5)


def test_fused_update_equals_fresh_update_bitwise():
    cfg = _models()["tiny"]
    params = registry.init_params(cfg, prng.key(5), "cpu")
    twin = jax.tree_util.tree_map(torch.clone, params)
    p_hat = torch.tensor(0.37)
    seeds = zo.seed_row(9, len(zo.flatten(params)))
    zo.apply_update(params, seeds, p_hat, 0.1, EPS, mode="fused")
    zo.apply_update(twin, seeds, p_hat, 0.1, EPS, mode="fresh")
    for (path, a), (_, b) in zip(zo.flatten(params), zo.flatten(twin)):
        assert torch.equal(a, b), path


def test_four_fused_rounds_match_reference(monkeypatch):
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    pz = dataclasses.replace(pz, fused_perturbation=True)
    jpz = dataclasses.replace(jpz, fused_perturbation=True)
    jpipe = JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0)
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))

    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=4, engine="loop",
                      params=jparams, dtype=jnp.float32)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    res = fedsim.run(cfg, pz, pipe, rounds=4, params=params, device="cpu")
    assert res.steps == ref.steps == 4
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(res.p_hats, ref.p_hats, rtol=1e-4, atol=1e-3)
    assert res.privacy_spent == ref.privacy_spent


def test_fused_rejects_the_ssm_family_and_builds_for_moe():
    """The ssm family has no fused path; the moe family has one, as in
    the reference (a round of it: test_torch_slice.py)."""
    _, pz = configs(base, n_perturb=1)
    pz = dataclasses.replace(pz, fused_perturbation=True)
    with pytest.raises(ValueError, match="fused_perturbation"):
        pairzero.make_zo_step(get_arch("mamba2-370m").reduced(), pz)
    moe = get_arch("moonshot-v1-16b-a3b").reduced()
    assert callable(pairzero.make_zo_step(moe, pz))
