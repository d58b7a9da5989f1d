"""The port's hybrid family (RG-LRU + local attention) and its linear
recurrence against `repro`.

Tolerances:
- `linear_recurrence_plain` against `repro.kernels.ref.linear_recurrence_ref`
  and `repro.kernels.ops.linear_recurrence` (the Pallas kernel in
  interpret mode): atol 2e-5, rtol 2e-4, the reference's own kernel
  tolerance (`tests/test_kernels.py::test_linear_recurrence`);
- `attention_plain` with one kv head and a window that binds, against
  `ref.attention_ref`: atol/rtol 1e-5 (f32 sums in another order);
- per-client losses of `recurrentgemma-2b.reduced()` (no attention block)
  and `.reduced(n_layers=5)` (one rra group, a tail of two) from the same
  weights: rtol 1e-5;
- one round's losses rtol 1e-5, p_clients and p̂ within the projection
  error that a 1e-5 loss error makes, new weights atol 1e-5; the 4-round
  trajectory rtol 1e-4 (f32 differences compound through the updates).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.channel import RayleighFading  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import pairzero as jpairzero  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base, get_arch, list_archs  # noqa: E402
from repro_torch.core import engine, fedsim, pairzero, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan  # noqa: E402
from repro_torch.models import hybrid, registry  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import _batch, configs, jax_noise_rows  # noqa: E402
from test_torch_slice import jax_trace_noise  # noqa: E402

ARCH = "recurrentgemma-2b"
DEPTHS = [None, 5, 6]          # 0 groups + tail 2; 1 group + tail 2; no tail


def _pair(n_layers=None):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    return get_arch(ARCH).reduced(**kw), jreg.get_arch(ARCH).reduced(**kw)


def _jpath(path) -> str:
    """A JAX key path in the port's notation: `groups.a.norm.g`,
    `tail[0].conv_w`."""
    out = ""
    for k in path:
        out += f"[{k.idx}]" if hasattr(k, "idx") else f".{k.key}"
    return out.lstrip(".")


def _jleaves(tree):
    return [(_jpath(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _to_torch(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def test_config_and_reduced_match_reference():
    assert ARCH in list_archs()
    for ours, theirs in [(get_arch(ARCH), jreg.get_arch(ARCH))] + [
            _pair(n) for n in DEPTHS]:
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "tie_embeddings", "subquadratic", "norm_eps", "rope_theta"):
            assert getattr(ours, f) == getattr(theirs, f), f
        assert ours.hybrid.__dict__ == theirs.hybrid.__dict__
        assert hybrid.layer_kinds(ours) == jhybrid.layer_kinds(theirs)
        assert hybrid._group_counts(ours) == jhybrid._group_counts(theirs)


def test_full_width_param_count():
    assert registry.count_params(get_arch(ARCH)) == 2_894_435_840
    assert len(registry.shapes(get_arch(ARCH))) == 59


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_leaf_order_and_shapes_match_reference(n_layers):
    """Dicts by sorted key, the `tail` list by index — every leaf seed
    depends on this order."""
    cfg, jcfg = _pair(n_layers)
    jtree = jreg.abstract_params(jcfg, jnp.float32)
    want = [(p, tuple(leaf.shape)) for p, leaf in _jleaves(jtree)]
    params = registry.init_params(cfg, prng.key(0), torch.device("meta"))
    assert [(p, tuple(t.shape)) for p, t in zo.flatten(params)] == want
    assert list(registry.shapes(cfg)) == [s for _, s in want]
    assert cfg.param_count() == jreg.count_params(jcfg)
    n_groups, tail = hybrid._group_counts(cfg)
    assert len(params["tail"]) == tail
    assert params["groups"]["r1"]["lambda_p"].shape[0] == n_groups
    # converted reference weights flatten in the same order, lists kept
    converted = _to_torch(jreg.init_params(jax.random.key(0), jcfg))
    assert isinstance(converted["tail"], list)
    assert [p for p, _ in zo.flatten(converted)] == [p for p, _ in want]


def test_init_scales_and_constant_fill():
    cfg, _ = _pair(5)
    params = registry.init_params(cfg, prng.key(0), "cpu")
    assert torch.equal(params["groups"]["r1"]["lambda_p"],
                       torch.full((1, 64), 2.0))
    assert torch.equal(params["tail"][1]["norm"]["g"], torch.ones(64))
    conv = params["tail"][0]["conv_w"]
    assert conv.shape == (4, 64)
    assert 0.3 < float(conv.std()) < 0.7          # 1/√conv1d_width = 0.5


def test_map_leaves_and_perturb_walk_lists():
    """`perturb` draws leaf i of the flattening order with leaf_seed(seed,
    i), tail entries included, and keeps the list structure."""
    cfg, _ = _pair(5)
    params = registry.init_params(cfg, prng.key(1), "cpu")
    seeds = zo.seed_row(77, len(zo.flatten(params)))
    new = zo.perturb(params, seeds, 0.5)
    assert isinstance(new["tail"], list) and len(new["tail"]) == 2
    flat_old, flat_new = zo.flatten(params), zo.flatten(new)
    for i, ((path, old), (path2, got)) in enumerate(zip(flat_old, flat_new)):
        assert path == path2
        want = ops.seeded_axpy(old, zo.leaf_seed(77, i),
                               torch.tensor(0.5, dtype=torch.float32))
        assert torch.equal(got, want), path
    tagged = zo.tag_perturbed(params, seeds, 0.5)
    assert int(tagged["tail"][1]["out"]["w"].seed) == zo.leaf_seed(
        77, [p for p, _ in flat_old].index("tail[1].out.w"))


@pytest.mark.parametrize("shape", [(1, 32, 16), (3, 64, 48), (2, 128, 256)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_linear_recurrence_plain_matches_reference(shape, with_h0):
    b, s, d = shape
    rng = np.random.default_rng(3)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    ja = [jnp.asarray(a), jnp.asarray(x),
          None if h0 is None else jnp.asarray(h0)]
    ta = [torch.from_numpy(a), torch.from_numpy(x),
          None if h0 is None else torch.from_numpy(h0)]
    hs, hl = rglru_scan.linear_recurrence_plain(*ta)
    for name, (hs_ref, hl_ref) in (
            ("ref", jref.linear_recurrence_ref(*ja)),
            ("pallas_interpret", jops.linear_recurrence(
                *ja, impl="pallas_interpret"))):
        np.testing.assert_allclose(hs.numpy(), np.asarray(hs_ref), atol=2e-5,
                                   rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref), atol=2e-5,
                                   rtol=2e-4, err_msg=name)
    # ops.linear_recurrence on CPU tensors is the plain version
    hs2, hl2 = ops.linear_recurrence(*ta)
    assert torch.equal(hs2, hs) and torch.equal(hl2, hl)
    assert torch.equal(hl, hs[:, -1])


def test_linear_recurrence_rejects_other_devices():
    meta = torch.empty((2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.linear_recurrence(meta, meta)


@pytest.mark.parametrize("case", [
    ((2, 4, 40, 16), (2, 1, 40, 16), True, 8),     # group 4, window binds
    ((1, 10, 24, 16), (1, 1, 64, 16), True, 32),   # group 10, Sq < Skv
])
def test_attention_plain_one_kv_head_with_window(case):
    qs, ks, causal, window = case
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in (qs, ks, ks))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    got = fa.attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                             causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_cuda_head_dims_include_256():
    assert 256 in fa.SUPPORTED_HEAD_DIMS
    assert get_arch(ARCH).resolved_head_dim() in fa.SUPPORTED_HEAD_DIMS


def _loss_batch(vocab, k=5, b=3, s=40, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(k, b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(k, b, s)).astype(np.int32),
            "mask": (rng.random((k, b, s)) < 0.5).astype(np.float32)}


def _jparams(jcfg, seed):
    """The reference's init, with lambda_p moved off its constant 2.0 so
    the decay differs per channel."""
    jparams = jreg.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)

    def spread(block):
        lam = block["lambda_p"]
        return {**block, "lambda_p": jnp.asarray(
            (np.asarray(lam) + rng.standard_normal(lam.shape) * 0.5
             ).astype(np.float32))}
    groups = {**jparams["groups"],
              "r1": spread(jparams["groups"]["r1"]),
              "r2": spread(jparams["groups"]["r2"])}
    return {**jparams, "groups": groups,
            "tail": [spread(b) for b in jparams["tail"]]}


@pytest.mark.parametrize("n_layers", [5, None])
def test_loss_per_client_matches_reference(n_layers):
    """Seq 40 > window 32: the attention block's window binds."""
    cfg, jcfg = _pair(n_layers)
    jparams = _jparams(jcfg, 3)
    batch = _loss_batch(cfg.vocab_size)
    want = np.asarray(jhybrid.loss_per_client(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        impl="xla"))
    got = hybrid.loss_per_client(_to_torch(jparams), cfg, _torch_batch(batch))
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    nll = hybrid.token_nll(_to_torch(jparams), cfg,
                           _torch_batch(batch)["tokens"][0],
                           _torch_batch(batch)["targets"][0],
                           _torch_batch(batch)["mask"][0])
    assert float(nll.mean()) == pytest.approx(float(got[0]), rel=1e-6)


def test_one_round_matches_reference():
    cfg, jcfg = _pair(5)
    _, pz = configs(base)
    _, jpz = configs(jbase)
    h = RayleighFading().realize(0 ^ 0xC4A7, pz.rounds, 5)
    sched = jtp.resolve(jpz).make_schedule(h, jpz)
    t = 1
    jctl = jpairzero.make_control(t, sched, jpz.seed, 5)
    jparams = _jparams(jcfg, 1)
    batch = _batch(vocab=cfg.vocab_size)
    jnew, jm = jax.jit(jpairzero.make_zo_step(jcfg, jpz))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jctl)

    params = _to_torch(jparams)
    ctl = pairzero.make_control(t, sched, pz.seed, 5, pz.zo.n_perturb,
                                torch.device("cpu"),
                                n_leaves=len(zo.flatten(params)))
    ctl["noise"] = torch.from_numpy(
        jax_noise_rows(jctl["noise_bits"], pz.zo.n_perturb, 5))
    new, m = pairzero.make_zo_step(cfg, pz)(params, _torch_batch(batch), ctl)

    loss = float(jm["loss"])
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    p_atol = 2 * 1e-5 * abs(loss) / (2 * pz.zo.mu)
    np.testing.assert_allclose(m["p_clients"].numpy(),
                               np.asarray(jm["p_clients"]), rtol=0,
                               atol=p_atol)
    assert float(m["p_hat"]) == pytest.approx(float(jm["p_hat"]), abs=p_atol)
    jleaves = {p: np.asarray(leaf) for p, leaf in _jleaves(jnew)}
    flat = zo.flatten(new)
    assert [p for p, _ in flat] == list(jleaves)
    for path, leaf in flat:
        np.testing.assert_allclose(leaf.numpy(), jleaves[path], rtol=0,
                                   atol=1e-5, err_msg=path)


def test_four_rounds_match_reference(monkeypatch):
    cfg, jcfg = _pair(5)
    _, pz = configs(base, n_perturb=2)
    _, jpz = configs(jbase, n_perturb=2)
    jpipe = JPipe("sst2", JSpec("sst2", cfg.vocab_size, 40), 5, 4, seed=0)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", cfg.vocab_size, 40), 5,
                             4, seed=0)
    jparams = _jparams(jcfg, 0)
    params = _to_torch(jparams)
    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=4, engine="loop",
                      params=jparams, dtype=jnp.float32)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    res = fedsim.run(cfg, pz, pipe, rounds=4, params=params, device="cpu")
    assert res.steps == ref.steps == 4
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


def test_fused_perturbation_raises_for_the_hybrid_family():
    cfg, _ = _pair(5)
    _, pz = configs(base)
    with pytest.raises(ValueError, match="dense/moe"):
        pairzero.make_zo_step(cfg, dataclasses.replace(
            pz, fused_perturbation=True))


def test_cli_runs_the_hybrid_family_on_cpu(capsys):
    from repro_torch.launch import train
    summary = train.main(["--arch", ARCH, "--reduced", "--rounds", "2",
                          "--device", "cpu", "--clients", "3", "--batch",
                          "2", "--seq-len", "16", "--n-perturb", "1"])
    assert summary["arch"] == ARCH and summary["rounds"] == 2
    assert np.isfinite(summary["final_loss"])
    assert '"final_loss"' in capsys.readouterr().out
