"""The port's serve paths (dense, moe, ssm, hybrid), `launch/serve.py`
and `examples/serve_batched.py` against `repro` on the CPU.

Seven configurations, each package from the same seed (the port's
threefry draws `repro`'s weights: `test_torch_prng.py`):
- `dense`: the tiny dense config (2 layers, head_dim 16, 4 q heads on 2);
- `yi128`: `yi-6b.reduced(head_dim=128, n_heads=8, n_kv_heads=2)`, yi-6b's
  head dim on a group of 4;
- `ssm`: `mamba2-370m.reduced()`, a 40-token prompt (its chunk, 32, does
  not divide 40, so the prefill runs one chunk of 40, as the reference);
- `hybrid`: `recurrentgemma-2b.reduced(n_layers=5)`, one rra group and a
  tail of two; 24 + 16 tokens, so decode wraps the 32-slot window;
- `minicpm3`: `minicpm3-4b.reduced()`, MLA: the latent cache, absorbed
  decode;
- `deepseek`: `deepseek-v2-236b.reduced()`, MLA and MoE with a shared
  expert;
- `moonshot`: `moonshot-v1-16b-a3b.reduced()`, GQA and MoE.

Tolerances (f32 on both sides; the only differences are summation
orders, XLA's fused multiply-adds and the weights' last ulps):
- `LOGITS`, port against `repro` on the same inputs (prefill logits,
  teacher-forced decode logits): rtol 1e-5, atol 1e-5 (the logits are
  about 0.1 in size; the ssm prefill's, over one 40-row chunk, differ by
  up to 2.0e-6, above an atol of 1e-6);
- `STATE`, every cache and state leaf: rtol 1e-5, atol 1e-5 (the SSD
  state sums up to 40 rank-one updates);
- `DECODE`, port only, stepwise decode logits against the full forward's
  at the same positions: rtol 2e-3, atol 2e-3, the tolerance
  `tests/test_models.py` holds `repro`'s own decode to. The two are
  different algorithms (the recurrence against the chunked scan, the
  cache against flash attention) and part by f32 rounding that grows
  with depth: on an NVIDIA H100 (700 W), full-width mamba2-370m reads
  8.3e-6 after one layer, 1.8e-4 after 12 and 3.6e-4 after 48, with the
  kernels and with the plain versions alike (logits up to 3.0).
  `chip_smoke.py` holds the full-width paths on the card to this
  tolerance. A capacity-bound MoE forward drops tokens over an expert's
  capacity and a one-token decode step drops none, so the moe family is
  held there at a capacity factor E/k, where the forward drops none
  either;
- greedy tokens: equal, after a check that every step's top-2 logit gap
  exceeds LOGITS's tolerance at the top logit (else the two packages may
  rightly part on a near-tie, and the test says so instead).
"""
import functools
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import zo  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, registry, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

LOGITS = dict(rtol=1e-5, atol=1e-5)
STATE = dict(rtol=1e-5, atol=1e-5)
DECODE = dict(rtol=2e-3, atol=2e-3)
SEED = 3
BATCH = 2
FAMILIES = ["dense", "yi128", "ssm", "hybrid", "minicpm3", "deepseek",
            "moonshot"]
# prompt and generated lengths per configuration
LENGTHS = {"dense": (16, 8), "yi128": (16, 8), "ssm": (40, 8),
           "hybrid": (24, 16), "minicpm3": (16, 8), "deepseek": (16, 8),
           "moonshot": (16, 8)}


def _configs(name):
    if name == "dense":
        kw = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                  head_dim=16)
        return ModelConfig(**kw), JModelConfig(**kw)
    arch, kw = {"yi128": ("yi-6b", dict(head_dim=128, n_heads=8,
                                        n_kv_heads=2)),
                "ssm": ("mamba2-370m", {}),
                "hybrid": ("recurrentgemma-2b", dict(n_layers=5)),
                "minicpm3": ("minicpm3-4b", {}),
                "deepseek": ("deepseek-v2-236b", {}),
                "moonshot": ("moonshot-v1-16b-a3b", {})}[name]
    return get_arch(arch).reduced(**kw), jreg.get_arch(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Configs, weights of both packages from SEED, and the reference's
    jitted serve functions."""
    cfg, jcfg = _configs(name)
    jmod = jreg.get_module(jcfg)
    return {
        "cfg": cfg, "jcfg": jcfg, "mod": registry.get_module(cfg),
        "jmod": jmod,
        "params": registry.init_params(cfg, prng.key(SEED), "cpu"),
        "jparams": jreg.init_params(jax.random.key(SEED), jcfg),
        "prefill": jax.jit(lambda p, t: jmod.prefill(p, jcfg, t)),
        "decode": jax.jit(lambda p, c, t, pos: jmod.decode_step(
            p, jcfg, c, t, pos)),
    }


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        8, cfg.vocab_size, size=shape).astype(np.int32)


def _long(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}.{p}".rstrip("."), v) for k in sorted(tree)
                for p, v in _leaves(tree[k])]
    return [("", tree)]


def _assert_tree_close(got, want, **tol):
    got, want = _leaves(got), _leaves(jax.tree_util.tree_map(np.asarray,
                                                              want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, err_msg=path, **tol)


def _jcache(case, small, max_len):
    """The reference's prefill cache in a buffer of max_len positions, as
    its serve_loop makes it (dense, moe); the ssm and hybrid state as it
    is."""
    if case["cfg"].family not in ("dense", "moe"):
        return small
    big = case["jmod"].init_cache(case["jcfg"], BATCH, max_len,
                                  dtype=jnp.float32)
    return jax.tree_util.tree_map(
        lambda b, s: jax.lax.dynamic_update_slice(b, s, (0,) * b.ndim),
        big, small)


def _cache(case, small, max_len):
    """The port's counterpart of `_jcache`."""
    if case["cfg"].family not in ("dense", "moe"):
        return small
    big = transformer.init_cache(case["cfg"], BATCH, max_len, device="cpu")
    for name, c in small.items():
        big[name][:, :, :c.shape[2]] = c
    return big


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_state_shapes_match_reference(name):
    """init_cache / init_state (f32) and serve_cache_shapes (the
    reference's default bf16, on the meta device) against the reference's
    shapes and dtypes, leaf for leaf."""
    case = _case(name)
    cfg, jcfg = case["cfg"], case["jcfg"]
    if cfg.family in ("dense", "moe"):
        ours = transformer.init_cache(cfg, BATCH, 20, device="cpu")
        ref = case["jmod"].init_cache(jcfg, BATCH, 20, dtype=jnp.float32)
    else:
        ours = case["mod"].init_state(cfg, BATCH, device="cpu")
        ref = case["jmod"].init_state(jcfg, BATCH, dtype=jnp.float32)
    shapes = registry.serve_cache_shapes(cfg, BATCH, 20)
    jshapes = jreg.serve_cache_shapes(jcfg, BATCH, 20)
    for got, want in ((ours, ref), (shapes, jshapes)):
        got, want = _leaves(got), _leaves(want)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape), path
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    assert all(t.device.type == "meta" for _, t in _leaves(shapes))
    assert all(not t.any() for _, t in _leaves(ours))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(name):
    """The last logits and every cache / state leaf."""
    case = _case(name)
    s, _ = LENGTHS[name]
    tokens = _tokens(case["cfg"], (BATCH, s))
    want_logits, want_state = case["prefill"](case["jparams"],
                                              jnp.asarray(tokens))
    logits, state = case["mod"].prefill(case["params"], case["cfg"],
                                        _long(tokens))
    assert logits.shape == (BATCH, 1, case["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **LOGITS)
    _assert_tree_close(state, want_state, **STATE)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_match_reference(name):
    """Eight teacher-forced decode steps from the reference's prefill
    cache: the logits and every state leaf after each step."""
    case = _case(name)
    s, _ = LENGTHS[name]
    steps = 8
    cfg = case["cfg"]
    prompt = _tokens(cfg, (BATCH, s))
    feed = _tokens(cfg, (BATCH, steps), seed=1)
    _, small = case["prefill"](case["jparams"], jnp.asarray(prompt))
    jcache = _jcache(case, small, s + steps)
    cache = _to_torch(jcache)
    for i in range(steps):
        want, jcache = case["decode"](case["jparams"], jcache,
                                      jnp.asarray(feed[:, i:i + 1]),
                                      jnp.int32(s + i))
        got, cache = case["mod"].decode_step(case["params"], cfg, cache,
                                             _long(feed[:, i:i + 1]), s + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {i}", **LOGITS)
        _assert_tree_close(cache, jcache, **STATE)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(5)
    b, h, p, n = 3, 4, 8, 16
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bt, ct = (rng.standard_normal((b, n)).astype(np.float32)
              for _ in range(2))
    want_y, want_s = jops.ssd_decode_step(*map(jnp.asarray, (
        state, x, dt, a, bt, ct)))
    y, s = ops.ssd_decode_step(*map(torch.from_numpy, (state, x, dt, a, bt,
                                                       ct)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **STATE)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **STATE)


def _near_ties(case, out, s, gen):
    """The reference's logits at every greedy step of its own output,
    teacher-forced: the steps whose top-2 gap is within LOGITS's
    tolerance of the top logit."""
    logits, small = case["prefill"](case["jparams"], jnp.asarray(out[:, :s]))
    cache = _jcache(case, small, s + gen)
    rows = [np.asarray(logits)[:, -1]]
    for i in range(gen - 1):
        logits, cache = case["decode"](case["jparams"], cache,
                                       jnp.asarray(out[:, s + i:s + i + 1]),
                                       jnp.int32(s + i))
        rows.append(np.asarray(logits)[:, -1])
    ties = []
    for i, row in enumerate(rows):
        top2 = np.sort(row, axis=-1)[:, -2:]
        tol = LOGITS["atol"] + LOGITS["rtol"] * np.abs(top2[:, 1])
        ties += [(i, r) for r in np.nonzero(top2[:, 1] - top2[:, 0]
                                            <= tol)[0]]
    return ties


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_loop_matches_reference(name):
    """The greedy tokens of both packages' serve_loop, equal."""
    case = _case(name)
    s, gen = LENGTHS[name]
    tokens = _tokens(case["cfg"], (BATCH, s))
    want = jserve.serve_loop(case["jcfg"], case["jparams"], tokens, gen)
    ties = _near_ties(case, want, s, gen)
    assert not ties, (f"near-ties (step, row) {ties}: top-2 logit gap "
                      "within the logits tolerance, the packages may part")
    got = serve.serve_loop(case["cfg"], case["params"], tokens, gen)
    assert got.dtype == np.int32 and got.shape == (BATCH, s + gen)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", ["dense", "yi128", "ssm", "minicpm3",
                                  "deepseek", "moonshot"])
def test_decode_matches_forward(name):
    """Port only: prefill of a prompt, then stepwise decode, gives the full
    forward's logits at every position from the prompt's last on (MoE at
    the capacity factor E/k, which drops no token)."""
    import dataclasses
    case = _case(name)
    cfg, mod, params = case["cfg"], case["mod"], case["params"]
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts
            / cfg.moe.n_experts_per_tok))
    s, steps = 12, 8
    tokens = _long(_tokens(cfg, (BATCH, s + steps), seed=2))
    want = layers.logits(params, mod.forward(params, cfg, tokens))[:, s - 1:]
    logits, small = mod.prefill(params, cfg, tokens[:, :s])
    cache = _cache(case, small, s + steps)
    got = [logits[:, 0]]
    for i in range(steps - 1):
        logits, cache = mod.decode_step(params, cfg, cache,
                                        tokens[:, s + i:s + i + 1], s + i)
        got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(),
                               want[:, :steps].numpy(), **DECODE)


def test_decode_writes_the_cache_in_place():
    """A dense decode step writes its k/v at cache_pos of the buffer it was
    given (no copy of the cache) and leaves the other slots alone."""
    case = _case("dense")
    cfg, params = case["cfg"], case["params"]
    cache = transformer.init_cache(cfg, BATCH, 10, device="cpu")
    cache["k"].fill_(7.0)
    ptr = cache["k"].data_ptr()
    _, out = transformer.decode_step(params, cfg, cache,
                                     _long(_tokens(cfg, (BATCH, 1))), 4)
    assert out is cache and out["k"].data_ptr() == ptr
    keep = torch.ones(10, dtype=torch.bool)
    keep[4] = False
    assert (cache["k"][:, :, keep] == 7.0).all()
    assert (cache["k"][:, :, 4] != 7.0).all()


def test_hybrid_prefill_returns_a_zero_state():
    """As the reference's: the last logits of the full forward and a fresh
    state (ROADMAP, findings of the reference)."""
    case = _case("hybrid")
    _, state = case["mod"].prefill(case["params"], case["cfg"],
                                   _long(_tokens(case["cfg"], (BATCH, 24))))
    assert all(not t.any() for _, t in _leaves(state))


@pytest.mark.parametrize("arch", ["opt-125m", "mamba2-370m",
                                  "recurrentgemma-2b", "yi-6b",
                                  "minicpm3-4b", "deepseek-v2-236b",
                                  "moonshot-v1-16b-a3b"])
def test_serve_cli_matches_reference(arch, capsys, monkeypatch):
    """`main([... --device cpu --reduced])` prints the reference CLI's
    sample row from the same --seed."""
    flags = ["--arch", arch, "--reduced", "--batch", "2", "--gen", "6",
             "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    out = serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert out.shape == (2, 32 + 6)
    assert got[0].startswith(f"arch={arch} generated 6 tokens x batch 2")
    assert got[1] == want[1]


def test_serve_batched_matches_reference(capsys, monkeypatch):
    """The example's left-padded requests: the reference example's lines
    (but its timings) from the port's serve_loop."""
    monkeypatch.setattr(sys, "argv", ["serve_batched", "--gen", "5"])
    runpy.run_path("examples/serve_batched.py", run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    out = serve_batched.main(["--gen", "5", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert out.shape == (4, 37)
    assert got[0] == want[0] and got[2:] == want[2:]


def test_yi_6b_config_matches_reference():
    ours, ref = get_arch("yi-6b"), jreg.get_arch("yi-6b")
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "rope_theta", "norm_eps", "tie_embeddings"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.param_count() == jreg.count_params(ref)


def test_flash_attention_cuda_takes_head_dim_128(monkeypatch):
    """yi-6b's prefill shape passes every check of the CUDA wrapper and
    reaches the library load (stopped there: no card here)."""
    def no_load(name):
        raise LookupError(f"library {name}")

    monkeypatch.setattr(build, "load", no_load)
    q = torch.zeros((4, 32, 32, 128), device="meta")
    k = torch.zeros((4, 4, 32, 128), device="meta")
    with pytest.raises(LookupError, match="flash_attention"):
        fa.flash_attention_cuda(q, k, k.clone())
    assert 128 in fa.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_attention_plain_matches_reference_at_head_dim_128(impl):
    """The plain version at yi-6b's head dim and GQA group of 8, causal
    with Sq < Skv (the reference pads nothing at 128)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 8, 20, 128)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, 28, 128)).astype(np.float32)
            for _ in range(2))
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, impl=impl)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("what,item", [("impl", "A12"), ("vlm", "A8"),
                                       ("audio", "A8"), ("prefix", "A8")])
def test_unported_serve_options_raise(what, item):
    """The A12 case: `impl=` runs since A12's first part (the plain
    versions by name, the same tokens on the CPU), and bf16 weights of a
    family it does not hold in bf16 (the vlm here) raise naming A12. The
    A8 cases (the vlm and audio families, prefill behind prefix_embeds)
    are ported now and run: the vlm family with no frontend tokens
    serves what the dense family serves, reduced whisper-medium serves
    the reference's tokens, and a prefill behind two prefix embeddings
    fills a cache of 2 + S positions whose logits are the forward's."""
    import dataclasses

    case = _case("dense")
    cfg, params = case["cfg"], case["params"]
    tokens = _tokens(cfg, (BATCH, 4))
    if what == "impl":
        np.testing.assert_array_equal(
            serve.serve_loop(cfg, params, tokens, 2, impl="xla"),
            serve.serve_loop(cfg, params, tokens, 2))
        bf16 = zo.rebuild(params, [t.to(torch.bfloat16)
                                   for _, t in zo.flatten(params)])
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            serve.serve_loop(dataclasses.replace(cfg, family="vlm"), bf16,
                             tokens, 2)
    elif what == "vlm":
        got = serve.serve_loop(dataclasses.replace(cfg, family="vlm"),
                               params, tokens, 2)
        np.testing.assert_array_equal(
            got, serve.serve_loop(cfg, params, tokens, 2))
    elif what == "audio":
        wcfg = get_arch("whisper-medium").reduced()
        jcfg = jreg.get_arch("whisper-medium").reduced()
        wparams = registry.init_params(wcfg, prng.key(SEED), "cpu")
        jparams = jreg.init_params(jax.random.key(SEED), jcfg)
        wtok = _tokens(wcfg, (BATCH, 4))
        np.testing.assert_array_equal(
            serve.serve_loop(wcfg, wparams, wtok, 2),
            np.asarray(jserve.serve_loop(jcfg, jparams, wtok, 2)))
    else:
        prefix = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (BATCH, 2, 64)).astype(np.float32))
        logits, cache = transformer.prefill(params, cfg, _long(tokens),
                                            prefix_embeds=prefix)
        assert tuple(cache["k"].shape[:3]) == (cfg.n_layers, BATCH, 6)
        x = transformer.forward(params, cfg, _long(tokens),
                                prefix_embeds=prefix)
        np.testing.assert_allclose(
            logits.numpy(), layers.logits(params, x[:, -1:]).numpy(),
            **LOGITS)
