"""The port's Mamba-2 (ssm) family and its SSD scan against `repro`.

Tolerances:
- `ssd_plain` against `repro.kernels.ops.ssd` (the XLA impl and the Pallas
  kernel in interpret mode) and the sequential oracle `ref.ssd_ref`:
  rtol 1e-5 and atol 1e-5 on y and the final state (f32 sums and the
  chunked-vs-sequential decays round in other orders);
- per-client losses of `mamba2-370m.reduced()` from the same weights:
  rtol 1e-5;
- one round's losses rtol 1e-5 and new weights atol 1e-5; the 4-round
  trajectory rtol 1e-4 (f32 differences compound through the updates).
"""
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
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base, get_arch, list_archs  # noqa: E402
from repro_torch.core import engine, fedsim, pairzero, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import _batch, configs, jax_noise_rows  # noqa: E402
from test_torch_slice import jax_trace_noise  # noqa: E402

SSD_TOL = dict(rtol=1e-5, atol=1e-5)


def _ssd_inputs(bsz, s, h, p, n, seed=0, with_state=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(
        np.float32)                                       # softplus > 0
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    b = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((bsz, h, p, n)).astype(np.float32)
          if with_state else None)
    return x, dt, a, b, c, s0


SSD_CASES = [  # (B, S, H, P, N, chunk)
    (2, 96, 3, 16, 8, 32),        # three chunks
    (1, 64, 2, 8, 16, 16),        # four chunks
    (2, 40, 4, 16, 16, 64),       # chunk clamped to S
]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret", "ssd_ref"])
def test_ssd_plain_matches_reference(case, impl):
    bsz, s, h, p, n, chunk = case
    x, dt, a, b, c, s0 = _ssd_inputs(bsz, s, h, p, n)
    j = [jnp.asarray(v) for v in (x, dt, a, b, c, s0)]
    if impl == "ssd_ref":
        y_ref, st_ref = jref.ssd_ref(*j)
    else:
        y_ref, st_ref = jops.ssd(*j, chunk=chunk, impl=impl)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c, s0)]
    y, st = ssd_scan.ssd_plain(*t, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), **SSD_TOL)
    # ops.ssd on CPU tensors is the plain version; state0=None is zeros
    y2, st2 = ops.ssd(*t, chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(st2, st)
    y0, _ = ops.ssd(*t[:5], chunk=chunk)
    y0_ref, _ = jops.ssd(*j[:5], chunk=chunk, impl="xla")
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_ref), **SSD_TOL)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_ssd_y_only_entry_matches_reference(case, with_state, impl):
    """want_state=False returns (y, None) with y bitwise the stateful
    call's, held against the reference with and without a state0."""
    bsz, s, h, p, n, chunk = case
    x, dt, a, b, c, s0 = _ssd_inputs(bsz, s, h, p, n, seed=1,
                                     with_state=with_state)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, none = ops.ssd(*t, ts0, chunk=chunk, want_state=False)
    assert none is None
    y_full, st = ops.ssd(*t, ts0, chunk=chunk)
    assert st is not None and torch.equal(y, y_full)
    j = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    y_ref, _ = jops.ssd(*j, None if s0 is None else jnp.asarray(s0),
                        chunk=chunk, impl=impl)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **SSD_TOL)


@pytest.mark.parametrize("shape,chunk,match", [
    ((1, 32, 2, 65, 16), 32, "head_dim 65"),      # P > 64
    ((1, 32, 2, 16, 129), 32, "d_state 129"),     # N > 128
    ((1, 40, 2, 16, 16), 16, "multiple of chunk"),
])
def test_ssd_scan_cuda_rejects_before_any_launch(shape, chunk, match,
                                                 monkeypatch):
    """The wrapper's checks come before the library is built or loaded and
    before anything is allocated on a device: CPU tensors suffice."""
    from repro_torch.kernels import build

    def no_library(name):
        raise AssertionError(f"library {name} loaded before the checks")
    monkeypatch.setattr(build, "load", no_library)
    bsz, s, h, p, n = shape
    x, dt, a, b, c, _ = _ssd_inputs(bsz, s, h, p, n, with_state=False)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    before = ssd_scan.launches
    for want_state in (True, False):
        with pytest.raises(ValueError, match=match):
            ssd_scan.ssd_scan_cuda(*t, None, chunk, want_state=want_state)
    assert ssd_scan.launches == before


def test_ssd_plain_rejects_ragged_chunks():
    x, dt, a, b, c, _ = _ssd_inputs(1, 40, 2, 8, 8, with_state=False)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_plain(*t, None, 16)


_FIRST_SSD = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.kernels.ssd_scan import ssd_plain
rng = np.random.default_rng(0)
b, s, h, p, n = 8, 96, 3, 16, 8
args = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        for shape in ((b, s, h, p), (b, s, h), (h,), (b, s, n), (b, s, n))]
args[1] = args[1].abs() + 0.1                 # dt > 0, made without torch math
args[2] = -(args[2].abs() + 0.5)              # a < 0
first, _ = ssd_plain(*args, None, 32)
print(int((first != ssd_plain(*args, None, 32)[0]).sum()))
"""


def test_first_ssd_plain_in_a_fresh_process_is_thread_independent():
    """The first ssd_plain of a fresh process equals a later one, bitwise.

    Its exps are the process's first calls of MKL's vector math over
    OpenMP threads (the inputs are made without torch math), whose
    first-use set-up raced between threads: about 1 process in 16 got a
    chunk of y wrong at this shape, started 8 at a time. 32 fresh
    processes would all but surely show it (P ≈ 0.87 at that rate)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    width = min(8, os.cpu_count() or 1)
    diffs = []
    for _ in range(32 // width):
        procs = [subprocess.Popen([sys.executable, "-c", _FIRST_SSD, src],
                                  stdout=subprocess.PIPE, env=env, text=True)
                 for _ in range(width)]
        try:
            for p in procs:
                out, _ = p.communicate(timeout=300)
                assert p.returncode == 0
                diffs.append(int(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert len(diffs) == 32 // width * width
    assert diffs == [0] * len(diffs), diffs


def _pair():
    cfg = get_arch("mamba2-370m").reduced()
    jcfg = jreg.get_arch("mamba2-370m").reduced()
    return cfg, jcfg


def test_config_and_reduced_match_reference():
    assert "mamba2-370m" in list_archs()
    for ours, theirs in ((get_arch("mamba2-370m"),
                          jreg.get_arch("mamba2-370m")), _pair()):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "tie_embeddings", "subquadratic", "norm_eps"):
            assert getattr(ours, f) == getattr(theirs, f), f
        assert ours.ssm.__dict__ == theirs.ssm.__dict__


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_leaf_order_and_count_match_reference(which):
    cfg, jcfg = _pair()
    if which == "full":
        cfg, jcfg = get_arch("mamba2-370m"), jreg.get_arch("mamba2-370m")
    jtree = jreg.abstract_params(jcfg, jnp.float32)
    jpaths = [(".".join(str(k.key) for k in path), tuple(leaf.shape))
              for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    params = registry.init_params(cfg, prng.key(0), torch.device("meta"))
    assert [(p, tuple(t.shape)) for p, t in zo.flatten(params)] == jpaths
    assert [p for p, _ in jpaths] == [
        "blocks.a_log", "blocks.conv_w", "blocks.dt_bias",
        "blocks.gate_norm.g", "blocks.in_proj.w", "blocks.norm.g",
        "blocks.out_proj.w", "embed.w", "final_norm.g"]
    assert cfg.param_count() == jreg.count_params(jcfg)


def _loss_batch(vocab, k=5, b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(k, b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(k, b, s)).astype(np.int32),
            "mask": (rng.random((k, b, s)) < 0.5).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _jparams_nonzero(jcfg, seed):
    """The reference's init, with a_log and dt_bias moved off zero so the
    decays and step sizes differ per head."""
    jparams = jreg.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    blocks = dict(jparams["blocks"])
    for name in ("a_log", "dt_bias"):
        shape = blocks[name].shape
        blocks[name] = jnp.asarray(
            (rng.standard_normal(shape) * 0.5).astype(np.float32))
    return {**jparams, "blocks": blocks}


@pytest.mark.parametrize("seq", [24, 64])
def test_loss_per_client_matches_reference(seq):
    """seq 24 runs one chunk of 24 rows, seq 64 two chunks of 32."""
    cfg, jcfg = _pair()
    jparams = _jparams_nonzero(jcfg, 3)
    batch = _loss_batch(cfg.vocab_size, s=seq)
    want = np.asarray(jssm.loss_per_client(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        impl="xla"))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    got = ssm.loss_per_client(params, cfg, _torch_batch(batch))
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_one_round_matches_reference():
    cfg, jcfg = _pair()
    _, pz = configs(base)
    _, jpz = configs(jbase)
    h = RayleighFading().realize(0 ^ 0xC4A7, pz.rounds, 5)
    sched = jtp.resolve(jpz).make_schedule(h, jpz)
    t = 1
    jctl = jpairzero.make_control(t, sched, jpz.seed, 5)
    jparams = _jparams_nonzero(jcfg, 1)
    batch = _batch(vocab=cfg.vocab_size)
    jnew, jm = jax.jit(jpairzero.make_zo_step(jcfg, jpz))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jctl)

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ctl = pairzero.make_control(t, sched, pz.seed, 5, pz.zo.n_perturb,
                                torch.device("cpu"),
                                n_leaves=len(zo.flatten(params)))
    ctl["noise"] = torch.from_numpy(
        jax_noise_rows(jctl["noise_bits"], pz.zo.n_perturb, 5))
    new, m = pairzero.make_zo_step(cfg, pz)(params, _torch_batch(batch), ctl)

    loss = float(jm["loss"])
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    p_atol = 2 * 1e-5 * abs(loss) / (2 * pz.zo.mu)
    assert float(m["p_hat"]) == pytest.approx(float(jm["p_hat"]), abs=p_atol)
    jleaves = {".".join(str(k.key) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jnew)[0]}
    for path, leaf in zo.flatten(new):
        np.testing.assert_allclose(leaf.numpy(), jleaves[path], rtol=0,
                                   atol=1e-5, err_msg=path)


def test_four_rounds_match_reference(monkeypatch):
    cfg, jcfg = _pair()
    _, pz = configs(base, n_perturb=2)
    _, jpz = configs(jbase, n_perturb=2)
    jpipe = JPipe("sst2", JSpec("sst2", cfg.vocab_size, 24), 5, 4, seed=0)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", cfg.vocab_size, 24), 5,
                             4, seed=0)
    jparams = _jparams_nonzero(jcfg, 0)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=4, engine="loop",
                      params=jparams, dtype=jnp.float32)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    res = fedsim.run(cfg, pz, pipe, rounds=4, params=params, device="cpu")
    assert res.steps == ref.steps == 4
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


def test_cli_runs_the_ssm_family_on_cpu(capsys):
    from repro_torch.launch import train
    summary = train.main(["--arch", "mamba2-370m", "--reduced", "--rounds",
                          "2", "--device", "cpu", "--clients", "3",
                          "--batch", "2", "--seq-len", "16", "--n-perturb",
                          "1"])
    assert summary["arch"] == "mamba2-370m" and summary["rounds"] == 2
    assert np.isfinite(summary["final_loss"])
    assert '"final_loss"' in capsys.readouterr().out
