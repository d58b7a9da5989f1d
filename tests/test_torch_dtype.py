"""bf16 and `impl=` (ROADMAP A12) against `repro`: the dense family's GQA
models trained (chained and fused, loop and scan, with the eval hook) and
served in bfloat16, and the kernels' implementation picked by name.

The reference's bf16 runs go through XLA on the CPU, whose default
`xla_allow_excess_precision=true` drops the bf16 rounding between fused
f32 ops (a convert to bf16 and back to f32 is elided), so on the CPU
`repro`'s bf16 program is not computed as written; on a TPU, bf16 is
native. Its trajectories here therefore run once, in a subprocess with
`XLA_FLAGS=--xla_allow_excess_precision=false` (every `astype` rounds, as
the port's casts do), and are shared by the tests through a module
fixture. With it the port's bf16 forward from the same weights is the
reference's bitwise; what remains is the order of an f32 sum inside a
matmul, which now and then rounds one bf16 activation the other way.
At mu = 1e-3 a bf16 weight moves by about two bf16 ulps under w ± mu·z,
so such a flip moves L+ − L− and p̂ at the scale bf16 itself does.

Tolerances:
- plain versions on bf16 inputs against `repro.kernels.ops.*(impl="xla")`:
  seeded_axpy and the gathered rows bitwise (the same f32 sum, one
  rounding); attention and perturbed_matmul within one bf16 ulp (2⁻⁸
  relative: their f32 sums run in another order before the one rounding),
  of the value or, where a sum cancels toward zero, of 2⁻⁸ of the largest
  output;
- `params_from_numpy` bitwise; the bf16 init from the same seed: the port's
  f32 normals are within 4 f32 ulp of the reference's (`test_torch_prng`),
  so an element may round to the neighbouring bf16 value: at most 1 bf16
  ulp, on at most 0.1% of the elements;
- rounds (TF_ROUNDS = 8, each from the reference's own bf16 state, the
  same control block and batch): summed over the rounds, |port − repro
  bf16| of the loss and of p̂ is at most MARGIN = 0.5 of the summed
  |repro f32 − repro bf16|, repro's own bf16-vs-f32 gap from the same
  states;
- trajectories (4 rounds from the same bf16 weights, through `fedsim.run`,
  eval every 2): the port's loop ≡ its scan bitwise; summed over the
  rounds, |port − repro bf16| of the loss and of p̂ is at most
  TRAJ_MARGIN = 0.75 of repro's own bf16-vs-f32 gap (a flip early in a
  trajectory compounds through the updates, so the margin is looser than
  a round's);
- serve_loop on bf16 weights: prefill logits within PREFILL_MARGIN = 0.1 of
  repro's bf16-vs-f32 gap (max |Δ|), the greedy tokens equal.

Worker time alone: about 60 s, 31 of them the reference's subprocess. The
tiny rounds run on one intra-op thread (a module fixture), as
`test_torch_privacy.py`'s do.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.channel import RayleighFading  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim, pairzero, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import perturbed_matmul as pmm  # noqa: E402
from repro_torch.kernels import seeded_axpy as sa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs, jax_noise_rows  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODES = ("chained", "fused")
ROUNDS = 4
TF_ROUNDS = 8
K = 5
SEED = 0
MARGIN = 0.5
TRAJ_MARGIN = 0.75
PREFILL_MARGIN = 0.1
SERVE_SHAPE, SERVE_GEN = (2, 16), 8


def _configs(mod, mode):
    cfg, pz = configs(mod, n_perturb=1)
    return cfg, dataclasses.replace(pz, fused_perturbation=mode == "fused")


def _pipe(mod_pipe, mod_spec):
    return mod_pipe("sst2", mod_spec("sst2", 64, 24), K, 4, seed=SEED)


def _schedule(jpz):
    trace = RayleighFading().realize(SEED ^ 0xC4A7, jpz.rounds, K)
    return jtp.resolve(jpz).make_schedule(trace, jpz)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    """A numpy leaf as savez keeps it: bf16 as its uint16 bits."""
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# The reference, in a subprocess with excess precision off
# ---------------------------------------------------------------------------

def _reference(out: str) -> None:
    """Every `repro` bf16 (and f32) number the tests compare, into `out`.

    The rounds are `repro`'s round body (`make_zo_step`, jitted) under its
    own `make_control` and the pipeline's batches, one after the other:
    the loop engine's dispatch, whose losses and p̂ `repro.core.fedsim.run`
    reports bitwise for the same config and weights."""
    from repro.core import pairzero as jpairzero
    from repro.data.pipeline import FederatedPipeline as JPipe
    from repro.data.tasks import TaskSpec as JSpec
    from repro.launch import serve as jserve
    from repro.models import transformer as jT
    res = {}
    f32 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(jnp.float32), tree)
    for mode in MODES:
        jcfg, jpz = _configs(jbase, mode)
        sched, pipe = _schedule(jpz), _pipe(JPipe, JSpec)
        step = jax.jit(jpairzero.make_zo_step(jcfg, jpz))

        def rnd(t, params):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch(t).items()
                     if k != "labels"}
            return step(params, batch,
                        jpairzero.make_control(t, sched, jpz.seed, K))

        # the bf16 trajectory, each round's state kept, and from each
        # state the same round in f32
        state = jreg.init_params(jax.random.key(SEED), jcfg, jnp.bfloat16)
        for t in range(TF_ROUNDS):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(state)):
                res[f"{mode}/state{t}/{i}"] = _bits(np.asarray(leaf))
            _, m32 = rnd(t, f32(state))
            state, m16 = rnd(t, state)
            for key in ("loss", "p_hat"):
                res[f"{mode}/round{t}/bf16/{key}"] = np.asarray(m16[key])
                res[f"{mode}/round{t}/f32/{key}"] = np.asarray(m32[key])
        # the f32 trajectory from the same seed
        state = jreg.init_params(jax.random.key(SEED), jcfg, jnp.float32)
        for t in range(ROUNDS):
            state, m32 = rnd(t, state)
            for key in ("loss", "p_hat"):
                res[f"{mode}/traj{t}/f32/{key}"] = np.asarray(m32[key])
    # serving the tiny dense model from the same bf16 weights
    jcfg, _ = _configs(jbase, "chained")
    jp = jreg.init_params(jax.random.key(SEED), jcfg, jnp.bfloat16)
    tokens = _serve_tokens(jcfg)
    for dt, tree in (("bf16", jp), ("f32", f32(jp))):
        logits, _ = jT.prefill(tree, jcfg, jnp.asarray(tokens))
        res[f"serve/prefill/{dt}"] = np.asarray(logits, np.float32)
    res["serve/tokens"] = np.asarray(jserve.serve_loop(jcfg, jp, tokens,
                                                       SERVE_GEN))
    np.savez(out, **res)


def _serve_tokens(cfg):
    return np.random.default_rng(3).integers(
        8, cfg.vocab_size, size=SERVE_SHAPE).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(ROOT / "tests")]))
        subprocess.run([sys.executable, __file__, out], env=env, check=True,
                       timeout=600, cwd=ROOT)
        with np.load(out) as data:
            yield {k: data[k] for k in data.files}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny rounds on one intra-op thread: pooled threads beside the
    other workers slow them most, and the trajectories stay one sum
    order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves_from(ref, prefix, like):
    """The port's tree of `like` holding the reference's leaves saved under
    `prefix` (bf16 as its bits)."""
    leaves = []
    for i, (_, t) in enumerate(zo.flatten(like)):
        a = ref[f"{prefix}/{i}"]
        leaves.append(torch.from_numpy(a.copy()).view(torch.bfloat16)
                      if t.dtype == torch.bfloat16 else torch.from_numpy(a))
    return zo.rebuild(like, leaves)


def _bf16_like(cfg):
    return registry.init_params(cfg, prng.key(SEED), "meta", torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions on bf16 inputs
# ---------------------------------------------------------------------------

def _bf16(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16))


def _t(a):
    return params_from_numpy({"a": a})["a"]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _ulps_ok(got: torch.Tensor, want: np.ndarray, what: str):
    """|got − want| within one bf16 ulp of |want|, or of 2⁻⁸·max|want|
    where a sum cancels toward zero (its f32 terms are as large as the
    largest outputs, and their rounding apart lands there)."""
    w = torch.from_numpy(np.asarray(want.astype(np.float32)))
    err = (got.float() - w).abs()
    tol = bf16_ulp(torch.clamp_min(w.abs(), float(w.abs().max()) / 256))
    assert bool((err <= tol).all()), f"{what}: {float((err / tol).max())} ulp"


@pytest.mark.parametrize("case", ["axpy", "axpy_offset", "gather", "pmm",
                                  "attn_causal", "attn_gqa_window",
                                  "attn_d128"])
def test_bf16_plain_versions_match_reference_ops(case):
    """`repro`'s bf16 cases of `tests/test_kernels.py`: each plain version
    on bf16 inputs against `repro.kernels.ops.*(impl="xla")`."""
    rng = np.random.default_rng(11)
    if case.startswith("axpy"):
        w = _bf16(rng, (48, 80))
        off = 0 if case == "axpy" else 17 * 48 * 80
        if off:
            # a layer of a stacked leaf: the whole leaf's counters there
            whole = _bf16(rng, (20, 48, 80))
            whole[17] = w
            want = np.asarray(jops.seeded_axpy(jnp.asarray(whole), 777, 0.3,
                                               impl="xla"))[17]
        else:
            want = np.asarray(jops.seeded_axpy(jnp.asarray(w), 777, 0.3,
                                               impl="xla"))
        got = sa.seeded_axpy_plain(_t(w), 777, torch.tensor(0.3), off)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, _t(want))
    elif case == "gather":
        w = _bf16(rng, (64, 32))
        tok = rng.integers(0, 64, (3, 7)).astype(np.int32)
        pp = jops.PerturbedParam(jnp.asarray(w), jnp.uint32(99),
                                 jnp.arange(64, dtype=jnp.uint32) * 32,
                                 jnp.float32(-0.05))
        want = np.asarray(jops.perturbed_gather(pp, jnp.asarray(tok)))
        got = sa.seeded_gather_plain(_t(w), torch.from_numpy(tok), 99,
                                     torch.tensor(-0.05))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, _t(want))
    elif case == "pmm":
        x, w = _bf16(rng, (2, 9, 96)), _bf16(rng, (96, 40), 0.1)
        pp = jops.PerturbedParam(jnp.asarray(w), jnp.uint32(5),
                                 jnp.uint32(0), jnp.float32(1e-2))
        want = np.asarray(jops.perturbed_matmul(jnp.asarray(x), pp,
                                                impl="xla"))
        got = pmm.perturbed_matmul_plain(_t(x), _t(w), 5, 0,
                                         torch.tensor(1e-2))
        assert got.dtype == torch.bfloat16
        _ulps_ok(got, want, "perturbed_matmul")
    else:
        q_shape, kv_shape, window = {
            "attn_causal": ((2, 4, 24, 64), (2, 4, 24, 64), None),
            "attn_gqa_window": ((1, 8, 20, 32), (1, 2, 28, 32), 9),
            "attn_d128": ((1, 8, 16, 128), (1, 2, 16, 128), None)}[case]
        q, k, v = (_bf16(rng, s) for s in (q_shape, kv_shape, kv_shape))
        want = np.asarray(jops.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            window=window, impl="xla"))
        got = fa.attention_plain(_t(q), _t(k), _t(v), True, window)
        assert got.dtype == torch.bfloat16
        _ulps_ok(got, want, case)


def test_params_from_numpy_takes_bf16_leaves():
    """`repro`'s bf16 leaves (numpy arrays of ml_dtypes.bfloat16) arrive
    bitwise as torch.bfloat16, f32 leaves beside them unchanged."""
    jcfg, _ = configs(jbase)
    jp = _np_tree(jreg.init_params(jax.random.key(SEED), jcfg, jnp.bfloat16))
    got = params_from_numpy({**jp, "extra": np.arange(3, dtype=np.float32)})
    assert got["extra"].dtype == torch.float32
    for a, (_, t) in zip(jax.tree_util.tree_leaves(jp),
                         zo.flatten({k: got[k] for k in jp})):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_bf16_init_matches_reference():
    """The port's bf16 init from the same seed: its f32 normals cast to
    nearest even, ones made in bf16; within 1 bf16 ulp of the reference's
    on at most 0.1% of the elements, bitwise elsewhere."""
    cfg, _ = configs(base)
    jcfg, _ = configs(jbase)
    jp = params_from_numpy(_np_tree(jreg.init_params(
        jax.random.key(SEED), jcfg, jnp.bfloat16)))
    got = registry.init_params(cfg, prng.key(SEED), "cpu", "bfloat16")
    for (path, a), (_, b) in zip(zo.flatten(got), zo.flatten(jp)):
        assert a.dtype == b.dtype == torch.bfloat16, path
        differ = a != b
        assert float(differ.float().mean()) <= 1e-3, path
        gap = (a.float() - b.float()).abs()
        assert bool((gap <= bf16_ulp(b)).all()), path


# ---------------------------------------------------------------------------
# Rounds and trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_bf16_rounds_match_reference(ref, mode):
    """Each round from the reference's own bf16 state, control block and
    batch: the port's loss and p̂ within MARGIN of repro's bf16-vs-f32 gap
    from that state."""
    cfg, pz = _configs(base, mode)
    _, jpz = _configs(jbase, mode)
    sched = _schedule(jpz)
    pipe = _pipe(FederatedPipeline, TaskSpec)
    step = pairzero.make_zo_step(cfg, pz)
    like = _bf16_like(cfg)
    n_leaves = len(zo.flatten(like))
    base_key = jax.random.key(pz.seed ^ 0x5EED)
    errs, gaps = {}, {}
    for t in range(TF_ROUNDS):
        params = _leaves_from(ref, f"{mode}/state{t}", like)
        ctl = pairzero.make_control(t, sched, pz.seed, K, pz.zo.n_perturb,
                                    "cpu", n_leaves)
        ctl["noise"] = torch.from_numpy(jax_noise_rows(
            jax.random.key_data(jax.random.fold_in(base_key, t)),
            pz.zo.n_perturb, K))
        batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype ==
                                     np.int32 else v)
                 for k, v in pipe.batch(t).items() if k != "labels"}
        _, m = step(params, batch, ctl)
        for key in ("loss", "p_hat"):
            want = float(ref[f"{mode}/round{t}/bf16/{key}"])
            gaps[key] = gaps.get(key, 0.0) + abs(
                float(ref[f"{mode}/round{t}/f32/{key}"]) - want)
            errs[key] = errs.get(key, 0.0) + abs(float(m[key]) - want)
    for key in ("loss", "p_hat"):
        assert errs[key] <= MARGIN * gaps[key], (mode, key, errs, gaps)


@pytest.fixture(scope="module")
def trajectories(ref):
    """The port's 4-round bf16 runs from the reference's bf16 init, per
    mode and engine."""
    out = {}
    for mode in MODES:
        cfg, pz = _configs(base, mode)
        like = _bf16_like(cfg)
        for eng in ("loop", "scan"):
            out[mode, eng] = fedsim.run(
                cfg, pz, _pipe(FederatedPipeline, TaskSpec), rounds=ROUNDS,
                device="cpu", engine=eng, chunk_rounds=2, eval_every=2,
                dtype=jnp.bfloat16,
                params=_leaves_from(ref, f"{mode}/state0", like))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_bf16_trajectories_match_reference(ref, trajectories, mode):
    """Chained or fused, loop and scan, eval every 2: loop ≡ scan bitwise
    (losses, p̂, accuracies, final weights); against the reference, the
    losses' and p̂'s summed gaps within TRAJ_MARGIN of repro's own bf16-vs-
    f32 ones."""
    loop, scan = trajectories[mode, "loop"], trajectories[mode, "scan"]
    assert loop.steps == scan.steps == ROUNDS
    assert loop.losses == scan.losses and loop.p_hats == scan.p_hats
    assert loop.accuracies == scan.accuracies and len(loop.accuracies) == 2
    for (_, a), (_, b) in zip(zo.flatten(loop.params),
                              zo.flatten(scan.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for key, got in (("loss", loop.losses), ("p_hat", loop.p_hats)):
        want = np.array([ref[f"{mode}/round{t}/bf16/{key}"]
                         for t in range(ROUNDS)])
        f32 = np.array([ref[f"{mode}/traj{t}/f32/{key}"]
                        for t in range(ROUNDS)])
        err = np.abs(np.asarray(got) - want).sum()
        gap = np.abs(f32 - want).sum()
        assert err <= TRAJ_MARGIN * gap, (mode, key, err, gap)


def test_bf16_serve_loop_matches_reference(ref):
    """serve_loop on the reference's bf16 weights: a bf16 cache, prefill
    logits within PREFILL_MARGIN of repro's bf16-vs-f32 gap, the greedy
    tokens the reference's."""
    cfg, _ = configs(base)
    params = _leaves_from(ref, "chained/state0", _bf16_like(cfg))
    tokens = _serve_tokens(cfg)
    logits, cache = registry.get_module(cfg).prefill(
        params, cfg, torch.from_numpy(tokens.astype(np.int64)))
    assert all(c.dtype == torch.bfloat16 for c in cache.values())
    want = ref["serve/prefill/bf16"]
    gap = np.abs(ref["serve/prefill/f32"] - want).max()
    assert np.abs(logits.numpy() - want).max() <= PREFILL_MARGIN * gap
    np.testing.assert_array_equal(
        serve.serve_loop(cfg, params, tokens, SERVE_GEN),
        ref["serve/tokens"])


@pytest.mark.parametrize("case", ["flash_bf16_192", "flash_mixed",
                                  "pmm_mixed", "axpy_f16", "gather_f16"])
def test_bf16_wrappers_reject_before_any_library_load(monkeypatch, case):
    """What the CUDA wrappers do not take raises before nvcc or a library
    is touched: bf16 attention above head_dim 128 (no instance: ROADMAP
    A12), mixed dtypes, and float16."""
    from repro_torch.kernels import build

    def no_load(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", no_load)
    meta = dict(device="meta")
    seed = torch.zeros((), dtype=torch.int32, **meta)
    one = torch.zeros((), **meta)
    if case == "flash_bf16_192":
        q = torch.zeros((2, 4, 8, 192), dtype=torch.bfloat16, **meta)
        with pytest.raises(NotImplementedError, match="A12"):
            fa.flash_attention_cuda(q, q.clone(), q.clone())
        return
    with pytest.raises(ValueError):
        if case == "flash_mixed":
            q = torch.zeros((2, 4, 8, 64), dtype=torch.bfloat16, **meta)
            fa.flash_attention_cuda(q, q.float(), q.float())
        elif case == "pmm_mixed":
            pmm.perturbed_matmul_cuda(
                torch.zeros((8, 16), dtype=torch.bfloat16, **meta),
                torch.zeros((16, 8), **meta), seed, 0, one)
        elif case == "axpy_f16":
            w = torch.zeros(8, dtype=torch.float16, **meta)
            sa.seeded_axpy_cuda(w, seed, one, w)
        else:
            sa.seeded_gather_cuda(
                torch.zeros((8, 4), dtype=torch.float16, **meta),
                torch.zeros(3, dtype=torch.int64, **meta), seed, one)


# ---------------------------------------------------------------------------
# impl=
# ---------------------------------------------------------------------------

def test_impl_xla_is_the_default_on_the_cpu_bitwise():
    """On the CPU `impl="xla"` (and the other plain names) runs what
    `impl=None` runs, bitwise, in f32 and in bf16; `serve_loop` too."""
    cfg, pz = configs(base, n_perturb=1)
    for dtype in (torch.float32, torch.bfloat16):
        runs = [fedsim.run(cfg, pz, _pipe(FederatedPipeline, TaskSpec),
                           rounds=2, device="cpu", dtype=dtype, impl=impl,
                           eval_every=2)
                for impl in (None, "xla", "xla_chunked", "xla_full",
                             "pallas_interpret")]
        for r in runs[1:]:
            assert r.losses == runs[0].losses
            assert r.p_hats == runs[0].p_hats
            assert r.accuracies == runs[0].accuracies
    params = registry.init_params(cfg, prng.key(1), "cpu", torch.bfloat16)
    tokens = _serve_tokens(cfg)
    np.testing.assert_array_equal(
        serve.serve_loop(cfg, params, tokens, 3, impl="xla"),
        serve.serve_loop(cfg, params, tokens, 3))
    assert ops.current_impl() is None


@pytest.mark.parametrize("where", ["run", "serve", "ops"])
def test_impl_pallas_on_the_cpu_raises(where):
    """"pallas" is the CUDA kernels: a CPU run, serve or op has none."""
    cfg, pz = configs(base, n_perturb=1)
    with pytest.raises(ValueError, match="pallas"):
        if where == "run":
            fedsim.run(cfg, pz, _pipe(FederatedPipeline, TaskSpec), rounds=1,
                       device="cpu", impl="pallas")
        elif where == "serve":
            params = registry.init_params(cfg, prng.key(1), "cpu")
            serve.serve_loop(cfg, params, _serve_tokens(cfg), 2,
                             impl="pallas")
        else:
            with ops.use_impl("pallas"):
                ops.seeded_axpy(torch.zeros(4), 1, torch.tensor(1.0))
    assert ops.current_impl() is None


@pytest.mark.parametrize("where", ["run", "serve", "use_impl"])
def test_unknown_impl_raises(where):
    """As in `repro`: a name that is not one of its implementations raises
    ValueError, before any work."""
    cfg, pz = configs(base, n_perturb=1)
    with pytest.raises(ValueError, match="unknown impl"):
        if where == "run":
            fedsim.run(cfg, pz, _pipe(FederatedPipeline, TaskSpec), rounds=1,
                       device="cpu", impl="triton")
        elif where == "serve":
            params = registry.init_params(cfg, prng.key(1), "cpu")
            serve.serve_loop(cfg, params, _serve_tokens(cfg), 2,
                             impl="cuda")
        else:
            with ops.use_impl("xla_fast"):
                pass
    assert set(ops.IMPLS) == {"pallas", "pallas_interpret", "xla",
                              "xla_chunked", "xla_full"}


def test_graph_key_names_the_implementation():
    """A scan engine's captured round records kernels or plain versions:
    its cache key carries the implementation and the leaves' dtype."""
    params = {"w": torch.zeros(3)}
    ctl, batch = {"c": torch.zeros(2)}, {"tokens": torch.zeros(2, 3)}
    key = engine._graph_key(params, ctl, batch)
    with ops.use_impl("xla"):
        assert engine._graph_key(params, ctl, batch) != key
    assert engine._graph_key({"w": params["w"].to(torch.bfloat16)}, ctl,
                             batch) != key


if __name__ == "__main__":
    _reference(sys.argv[1])
