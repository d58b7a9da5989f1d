"""The audio family (`whisper-medium.reduced()`: 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 8 frames of 64, the decoder's embedding
tied to its head) against `repro` on the CPU: the encoder's roped
non-causal self-attention and the decoder's unroped cross-attention, the
losses, prefill and decode with the self and cross caches, the eval hook,
training and serving, and the registry's shapes.

Both packages start from the reference's weights (`models/convert.py`),
or, for init, from the same seed. The text is longer than the frames (16
tokens on 8 frames), so the cross-attention has more queries than keys.

Tolerances (f32 on both sides; only summation orders differ):
- forwards (attention, encoder and decoder hidden states, losses,
  `token_nll`, prefill logits, every cache leaf, decode and eval logits):
  rtol 1e-5, atol 1e-5;
- the plain attention non-causal against `repro.kernels.ops.attention`
  (`xla`, `pallas_interpret`): rtol 1e-5, atol 1e-5;
- init: rtol 1e-6 (the port's normals are within 4 ulp of jax's);
- the 3-round chained-ZO trajectory: losses rtol 1e-4, p̂ rtol 1e-4 atol
  1e-3, the DP ledger equal, as `test_torch_slice.py`;
- the port's scan engine against its loop engine, the eval accuracies
  and `serve_loop`'s tokens: bitwise.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fedsim as jfedsim  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import encdec as jED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.core import fedsim  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from test_torch_vlm import (TOL, assert_inits_match,  # noqa: E402
                            assert_scan_equals_loop, assert_serve_matches,
                            assert_shapes_match, assert_trajectory_matches,
                            assert_tree_close, batch_of, flat_batch,
                            pipelines, reduced, weights)

ARCH = "whisper-medium"


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_init_matches_reference():
    assert_inits_match(ARCH)


@pytest.mark.parametrize("kind", ["encoder", "cross"])
def test_gqa_attend_matches_reference(kind):
    """`gqa_attend(causal=False)`: the encoder's self-attention (roped),
    and the cross-attention of 16 queries on 8 frames from `kv_x` (not
    roped)."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["dec_blocks"][
        "cross_attn"] if kind == "cross" else jparams["enc_blocks"]["attn"])
    p = L.layer_slice(params["dec_blocks"]["cross_attn"] if kind == "cross"
                      else params["enc_blocks"]["attn"], 0)
    x = _x((2, 16, 64), 1)
    kv = _x((2, 8, 64), 2) if kind == "cross" else None
    want = jax.jit(lambda p, x, kv: JL.gqa_attend(
        p, x, jnp.arange(16), jcfg, causal=False, kv_x=kv)[0])(
        jp, jnp.asarray(x), None if kv is None else jnp.asarray(kv))
    got = L.gqa_attend(p, torch.from_numpy(x), torch.arange(16), cfg,
                       causal=False,
                       kv_x=None if kv is None else torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the rope is what tells the two apart: the encoder's attention moves
    # when its positions shift, the cross-attention's does not
    moved = L.gqa_attend(p, torch.from_numpy(x), torch.arange(16) + 5, cfg,
                         causal=False,
                         kv_x=None if kv is None else torch.from_numpy(kv))
    assert torch.equal(moved, got) == (kind == "cross")


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("sq,skv", [(300, 300), (32, 300)])
def test_attention_plain_noncausal_matches_reference(impl, sq, skv):
    """The kernel's plain version at head_dim 64, non-causal: the
    encoder's shape (q = k = v) and the cross-attention's (fewer queries
    than keys), against the reference's oracle and its Pallas kernel in
    interpret mode."""
    q = _x((1, 2, sq, 64), 3)
    k, v = _x((1, 2, skv, 64), 4), _x((1, 2, skv, 64), 5)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, impl=impl)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_and_decode_hidden_match_reference():
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    tokens, _, _, frames = flat_batch(cfg)
    jenc = jax.jit(lambda p, f: jED.encode(p, jcfg, f))(
        jparams, jnp.asarray(frames))
    enc = encdec.encode(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    want = jax.jit(lambda p, t, e: jED.decode_hidden(p, jcfg, t, e))(
        jparams, jnp.asarray(tokens), jenc)
    got = encdec.decode_hidden(params, cfg, torch.from_numpy(tokens).long(),
                               enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["frames", "prefix_embeds"])
def test_token_nll_matches_reference(name):
    """`token_nll` given the frames by either name."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    tokens, targets, mask, frames = flat_batch(cfg)
    want = jax.jit(lambda p, t, y, m, f: jED.token_nll(
        p, jcfg, t, y, m, **{name: f}))(
        jparams, jnp.asarray(tokens), jnp.asarray(targets),
        jnp.asarray(mask), jnp.asarray(frames))
    got = encdec.token_nll(params, cfg, torch.from_numpy(tokens).long(),
                           torch.from_numpy(targets).long(),
                           torch.from_numpy(mask),
                           **{name: torch.from_numpy(frames)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_per_client_matches_reference():
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    _, pipe = pipelines(cfg)
    jb, tb = batch_of(pipe, 3)
    want = jax.jit(lambda p, b: jED.loss_per_client(p, jcfg, b))(
        jparams, jb)
    got = encdec.loss_per_client(params, cfg, tb)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_reference():
    """Prefill of 10 tokens on 8 random frames: the last logits, the self
    cache [L, B, 10, Hkv, hd] and the cross cache [L, B, 8, Hkv, hd]; then
    three decode steps from the self cache grown to 13, the logits and
    both caches (the self cache written in place, the cross cache
    untouched)."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10))
    frames = _x((2, 8, 64), 11)
    want, jcache = jax.jit(lambda p, t, f: jED.prefill(p, jcfg, t, f))(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    got, cache = encdec.prefill(params, cfg, torch.from_numpy(tokens),
                                torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(cache["self_k"].shape) == (2, 2, 10, 4, 16)
    assert tuple(cache["cross_v"].shape) == (2, 2, 8, 4, 16)
    assert_tree_close(cache, jcache, **TOL)

    grow = ("self_k", "self_v")
    jcache = {k: jnp.zeros(v.shape[:2] + (13,) + v.shape[3:]).at[
        :, :, :10].set(v) if k in grow else v for k, v in jcache.items()}
    cache = {k: serve._grown(v, 13) if k in grow else v
             for k, v in cache.items()}
    ptr, cross = cache["self_k"].data_ptr(), cache["cross_k"].clone()
    jdecode = jax.jit(lambda p, c, t, pos: jED.decode_step(p, jcfg, c, t,
                                                           pos))
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        want, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.int32(10 + i))
        got, cache = encdec.decode_step(params, cfg, cache,
                                        torch.from_numpy(tok), 10 + i)
        assert got.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {i}", **TOL)
    assert cache["self_k"].data_ptr() == ptr
    assert torch.equal(cache["cross_k"], cross)
    assert_tree_close(cache, jcache, **TOL)


def test_serve_loop_matches_reference():
    """Zero frames; only the self cache grows."""
    assert_serve_matches(ARCH)


def test_eval_hook_matches_reference():
    """The audio branch of the eval: zero frames encoded, the decoder, the
    tied `dec_embed` head at the last position; the hook's accuracies
    equal the reference's."""
    cfg, jcfg = reduced(ARCH)
    jparams, params = weights(ARCH)
    jpipe, pipe = pipelines(cfg)
    ebatch = pipe.eval_batch(12)
    jhook = jfedsim.EvalHook(1, eval_n=12)
    jexp = types.SimpleNamespace(model_cfg=jcfg, impl="xla",
                                 dtype=jnp.float32, pipeline=jpipe,
                                 params=jparams,
                                 result=types.SimpleNamespace(accuracies=[]))
    jhook.on_start(jexp)
    want = np.asarray(jhook._fn(jparams, ebatch))[:, -1]
    got = fedsim.eval_logits(params, cfg, torch.from_numpy(
        ebatch["tokens"].astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    hook = fedsim.EvalHook(1, eval_n=12)
    exp = types.SimpleNamespace(model_cfg=cfg, pipeline=pipe, params=params,
                                device=torch.device("cpu"),
                                result=types.SimpleNamespace(accuracies=[]))
    hook.on_boundary(1, exp)
    jhook.on_boundary(1, jexp)
    assert exp.result.accuracies == jexp.result.accuracies


def test_three_rounds_match_reference_loop_engine():
    assert_trajectory_matches(ARCH)


def test_scan_equals_loop_bitwise():
    """The port's scan engine (chunks of 2, eval every 2, the frames
    staged with the batch) against its loop engine."""
    assert_scan_equals_loop(ARCH)


def test_registry_shapes_match_reference():
    """At full size: 959,204,352 parameters, a train batch with 1500
    frames, the self cache at max_len and the cross cache at 1500."""
    assert_shapes_match(ARCH)


def test_cli_trains_and_serves_on_cpu():
    from repro_torch.launch import train
    summary = train.main(["--arch", ARCH, "--reduced", "--rounds", "2",
                          "--device", "cpu", "--clients", "3", "--batch",
                          "2", "--seq-len", "16", "--n-perturb", "1",
                          "--eval-every", "2"])
    assert summary["arch"] == ARCH and np.isfinite(summary["final_loss"])
    assert len(summary["accuracies"]) == 1
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out.shape == (2, 11)
