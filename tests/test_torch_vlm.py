"""The vlm family (`internvl2-76b.reduced()`: 2 layers, d_model 64, 8
patch embeddings of 64 prepended to the text) against `repro` on the CPU,
with the stub frontend's data and the registry's shape helpers.

Both packages start from the reference's weights (`models/convert.py`),
or, for init, from the same seed.

Tolerances (f32 on both sides; only summation orders differ):
- forwards (losses, `token_nll`, prefill logits, every cache leaf, decode
  logits): rtol 1e-5, atol 1e-5;
- init: rtol 1e-6 (the port's normals are within 4 ulp of jax's,
  `test_torch_prng.py`);
- the 3-round chained-ZO trajectory: losses rtol 1e-4, p̂ rtol 1e-4 atol
  1e-3, the DP ledger equal, as `test_torch_slice.py`;
- the pipeline's `prefix_embeds`, the port's scan engine against its loop
  engine and `serve_loop`'s tokens: bitwise.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base, get_arch, list_archs  # noqa: E402
from repro_torch.core import engine, fedsim, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs  # noqa: E402
from test_torch_slice import jax_trace_noise  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "internvl2-76b"
SEQ = 16
ROUNDS = 3          # chunks of 2 on scan: [0, 2) then [2, 3), one eval


def reduced(arch):
    return get_arch(arch).reduced(), jreg.get_arch(arch).reduced()


@functools.lru_cache(maxsize=None)
def host_weights(arch, seed=0):
    """The reference's init of the reduced config, as numpy arrays."""
    _, jcfg = reduced(arch)
    return jax.tree_util.tree_map(
        np.asarray, jreg.init_params(jax.random.key(seed), jcfg))


def weights(arch):
    """Fresh copies of those weights for each package (the reference's
    runs donate their params; the port's update theirs in place)."""
    host = host_weights(arch)
    return jax.tree_util.tree_map(jnp.array, host), params_from_numpy(host)


def pipelines(cfg, seed=0, k=5, b=4):
    """The reference's pipeline and the port's, with the stub frontend."""
    fe = dict(frontend_tokens=cfg.frontend.n_frontend_tokens,
              d_model=cfg.d_model)
    spec = (cfg.vocab_size, SEQ)
    return (JPipe("sst2", JSpec("sst2", *spec), k, b, seed=seed, **fe),
            FederatedPipeline("sst2", TaskSpec("sst2", *spec), k, b,
                              seed=seed, **fe))


def batch_of(pipe, t=0):
    """A round's batch as the reference's arrays and the port's tensors
    (token ids as int64, as the engine stages them)."""
    host = {k: v for k, v in pipe.batch(t).items() if k != "labels"}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in host.items()}
    return {k: jnp.asarray(v) for k, v in host.items()}, tb


def flat_batch(cfg, t=3):
    """Round t's batch of the default pipelines, its K·b = 20 rows
    flattened as `loss_per_client` flattens them (so the reference's
    compiled forward serves both tests): tokens, targets, mask, and the
    stub embeddings."""
    batch = pipelines(cfg)[1].batch(t)
    return tuple(batch[k].reshape((20,) + batch[k].shape[2:])
                 for k in ("tokens", "targets", "mask", "prefix_embeds"))


def assert_tree_close(got, want, **tol):
    """Every leaf of the port's tree against the reference's."""
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    pleaves = zo.flatten(got)
    assert len(jleaves) == len(pleaves)
    for (_, w), (path, g) in zip(jleaves, pleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=path,
                                   **tol)


def assert_inits_match(arch):
    """The port's init from seed 0 against the reference's (the weights
    the other tests start from)."""
    cfg, _ = reduced(arch)
    want = host_weights(arch)
    got = registry.init_params(cfg, prng.key(0), "cpu")
    assert [tuple(t.shape) for _, t in zo.flatten(got)] == [
        w.shape for w in jax.tree_util.tree_leaves(want)]
    assert_tree_close(got, want, rtol=1e-6, atol=0)


def assert_shapes_match(arch):
    """The registry's meta-device shapes against the reference's
    `eval_shape`s at full size: the params, a train batch of the
    reference's train_4k cell over 16 clients, and the serve state."""
    cfg, jcfg = get_arch(arch), jreg.get_arch(arch)
    assert list_archs() == jreg.list_archs()
    got = registry.abstract_params(cfg)
    want = jreg.abstract_params(jcfg)
    assert [(tuple(t.shape), t.dtype, t.device.type)
            for _, t in zo.flatten(got)] == [
        (w.shape, torch.bfloat16, "meta")
        for w in jax.tree_util.tree_leaves(want)]
    assert registry.count_params(cfg) == jreg.count_params(jcfg)
    cell = base.ShapeConfig("train_4k", 4096, 256, "train")
    got = registry.train_batch_shapes(cfg, cell, 16)
    want = jreg.train_batch_shapes(jcfg, jbase.TRAIN_4K, 16)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
    got = registry.serve_cache_shapes(cfg, 4, 300)
    want = jreg.serve_cache_shapes(jcfg, 4, 300)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == torch.bfloat16 and got[key].is_meta


@functools.lru_cache(maxsize=None)
def reference_run(arch, rounds=ROUNDS):
    """`repro`'s loop engine over `rounds` chained-ZO rounds of the reduced
    config from its own weights (one run shared by the tests)."""
    _, jcfg = reduced(arch)
    _, jpz = configs(jbase, n_perturb=2)
    jpipe, _ = pipelines(jcfg)
    return jfedsim.run(jcfg, jpz, jpipe, rounds=rounds, engine="loop",
                       params=weights(arch)[0], dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def port_run(arch, engine_name, rounds=ROUNDS):
    """The port's run of the same rounds (the reference's OTA normals
    injected, as `test_torch_slice.py`), with an eval every 2 rounds."""
    cfg, _ = reduced(arch)
    _, pz = configs(base, n_perturb=2)
    _, pipe = pipelines(cfg)
    saved = engine.noise_rows
    engine.noise_rows = jax_trace_noise
    try:
        return fedsim.run(cfg, pz, pipe, rounds=rounds,
                          params=weights(arch)[1],
                          device="cpu", engine=engine_name, chunk_rounds=2,
                          eval_every=2)
    finally:
        engine.noise_rows = saved


def assert_trajectory_matches(arch):
    ref, res = reference_run(arch), port_run(arch, "loop")
    assert res.steps == ref.steps == ROUNDS
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(res.p_hats, ref.p_hats, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(res.privacy_spent_per_round,
                                  ref.privacy_spent_per_round)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


def assert_scan_equals_loop(arch):
    loop, scan = port_run(arch, "loop"), port_run(arch, "scan")
    assert loop.losses == scan.losses and loop.p_hats == scan.p_hats
    assert loop.accuracies == scan.accuracies and len(loop.accuracies) == 1
    assert loop.privacy_spent == scan.privacy_spent
    for (path, a), (_, b) in zip(zo.flatten(loop.params),
                                 zo.flatten(scan.params)):
        assert torch.equal(a, b), path


def assert_serve_matches(arch):
    cfg, jcfg = reduced(arch)
    jparams, params = weights(arch)
    tokens = np.random.default_rng(2).integers(
        8, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = jserve.serve_loop(jcfg, jparams, tokens, 6)
    got = serve.serve_loop(cfg, params, tokens, 6)
    assert got.dtype == np.int32 and got.shape == (2, 18)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the stub frontend's data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,t", [(0, 0), (0, 3), (5, 1), (1, 1),
                                    (0xF0F0, 2), (77, 10 ** 6)])
def test_prefix_embeds_match_reference_bitwise(seed, t):
    """Every key of a round's batch bitwise, prefix_embeds [K, b, P, D] f32
    among them; (5, 1) and (1, 1) are seeds where `seed ^ 0xF0F0 + t`
    (+ binds first) and `(seed ^ 0xF0F0) + t` draw different streams."""
    cfg, _ = reduced(ARCH)
    jpipe, pipe = pipelines(cfg, seed=seed, k=3, b=2)
    want, got = jpipe.batch(t), pipe.batch(t)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["prefix_embeds"].shape == (3, 2, 8, 64)
    if (seed, t) in ((5, 1), (1, 1)):
        other = np.random.default_rng((seed ^ 0xF0F0) + t).standard_normal(
            (3, 2, 8, 64)).astype(np.float32) * 0.1
        assert not np.array_equal(other, got["prefix_embeds"])


def test_batch_stager_pins_the_prefix_embeds():
    """The engine's staging slot holds the new key at its shape and dtype
    (one [R, K, b, P, D] f32 block), and ships it bitwise."""
    cfg, _ = reduced(ARCH)
    _, pipe = pipelines(cfg, k=3, b=2)
    staged = engine.stack_batches(pipe, 2, 5, "cpu")
    assert sorted(staged) == ["mask", "prefix_embeds", "targets", "tokens"]
    assert tuple(staged["prefix_embeds"].shape) == (3, 3, 2, 8, 64)
    assert staged["prefix_embeds"].dtype == torch.float32
    for r, t in enumerate(range(2, 5)):
        np.testing.assert_array_equal(staged["prefix_embeds"][r].numpy(),
                                      pipe.prefix_embeds(t))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_matches_reference():
    assert_inits_match(ARCH)


@pytest.mark.parametrize("kind", ["prefix", "inputs", "both"])
def test_token_nll_with_embeds_matches_reference(kind):
    """`token_nll(prefix_embeds=)` (the loss on the text positions only),
    `inputs_embeds=` (the lookup replaced, tokens None) and both."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    tokens, targets, mask, prefix = flat_batch(cfg)
    emb = {}
    if kind in ("prefix", "both"):
        emb["prefix_embeds"] = prefix
    if kind in ("inputs", "both"):
        emb["inputs_embeds"] = np.random.default_rng(1).standard_normal(
            tokens.shape + (64,)).astype(np.float32)
    tok = None if kind != "prefix" else tokens
    want = jax.jit(lambda p, t, y, m, e: jT.token_nll(p, jcfg, t, y, m, **e))(
        jparams, None if tok is None else jnp.asarray(tok),
        jnp.asarray(targets), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in emb.items()})
    got = transformer.token_nll(
        params, cfg, None if tok is None else torch.from_numpy(tok).long(),
        torch.from_numpy(targets).long(), torch.from_numpy(mask),
        **{k: torch.from_numpy(v) for k, v in emb.items()})
    assert got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_per_client_matches_reference():
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    _, pipe = pipelines(cfg)
    jb, tb = batch_of(pipe, 3)
    want = jax.jit(lambda p, b: jreg.get_module(jcfg).loss_per_client(
        p, jcfg, b))(jparams, jb)
    got = registry.get_module(cfg).loss_per_client(params, cfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    del tb["prefix_embeds"]
    with pytest.raises(AssertionError, match="patch embeddings"):
        registry.get_module(cfg).loss_per_client(params, cfg, tb)


def test_prefill_and_decode_match_reference():
    """Prefill of random patch embeddings and 10 tokens: the last logits
    and every cache leaf ([L, B, P + S, Hkv, hd]); then three decode steps
    from that cache grown to P + S + 3, the logits and the cache written
    in place."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    jmod, mod = jreg.get_module(jcfg), registry.get_module(cfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    prefix = rng.standard_normal((2, 8, 64)).astype(np.float32)
    want, jcache = jax.jit(lambda p, t, e: jmod.prefill(
        p, jcfg, t, prefix_embeds=e))(jparams, jnp.asarray(tokens),
                                      jnp.asarray(prefix))
    got, cache = mod.prefill(params, cfg, torch.from_numpy(tokens).long(),
                             prefix_embeds=torch.from_numpy(prefix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(cache["k"].shape) == (2, 2, 18, 4, 16)
    assert_tree_close(cache, jcache, **TOL)

    jcache = {k: jnp.zeros(v.shape[:2] + (21,) + v.shape[3:]).at[
        :, :, :18].set(v) for k, v in jcache.items()}
    cache = {k: serve._grown(v, 21) for k, v in cache.items()}
    ptr = cache["k"].data_ptr()
    jdecode = jax.jit(lambda p, c, t, pos: jmod.decode_step(p, jcfg, c, t,
                                                            pos))
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.int32(18 + i))
        got, cache = mod.decode_step(params, cfg, cache,
                                     torch.from_numpy(tok).long(), 18 + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {i}", **TOL)
    assert cache["k"].data_ptr() == ptr
    assert_tree_close(cache, jcache, **TOL)


def test_serve_loop_matches_reference():
    """Zero patch embeddings in front of the prompt, decode from S + P."""
    assert_serve_matches(ARCH)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_three_rounds_match_reference_loop_engine():
    assert_trajectory_matches(ARCH)


def test_scan_equals_loop_bitwise():
    """The port's scan engine (chunks of 2, eval every 2) against its loop
    engine: losses, p̂, accuracies, privacy and final weights."""
    assert_scan_equals_loop(ARCH)


def test_eval_runs_without_a_prefix():
    """The vlm's eval hook scores the text alone, as the reference's: the
    backbone's forward on the eval tokens."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    _, pipe = pipelines(cfg)
    tokens = pipe.eval_batch(6)["tokens"]
    want = np.asarray(jax.jit(lambda p, t: jT.logits_from_hidden(
        p, jT.forward(p, jcfg, t)[:, -1]))(jparams, jnp.asarray(tokens)))
    got = fedsim.eval_logits(params, cfg,
                             torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_registry_shapes_match_reference():
    assert_shapes_match(ARCH)


def test_cli_trains_the_vlm_on_cpu():
    """`--arch internvl2-76b --reduced` through the training CLI: the
    pipeline carries the patch embeddings (the vlm's loss asserts them)."""
    from repro_torch.launch import train
    summary = train.main(["--arch", ARCH, "--reduced", "--rounds", "2",
                          "--device", "cpu", "--clients", "3", "--batch",
                          "2", "--seq-len", "16", "--n-perturb", "1",
                          "--eval-every", "2"])
    assert summary["arch"] == ARCH and summary["rounds"] == 2
    assert np.isfinite(summary["final_loss"])
    assert 0 < summary["privacy_spent"] <= summary["privacy_budget"]


def test_reduced_frontend_is_the_references():
    for arch in (ARCH, "whisper-medium"):
        cfg, jcfg = reduced(arch)
        assert dataclasses.asdict(cfg.frontend) == dataclasses.asdict(
            jcfg.frontend)
        full, jfull = get_arch(arch), jreg.get_arch(arch)
        assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
