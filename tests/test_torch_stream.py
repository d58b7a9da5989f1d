"""The port's counter-hash z stream and seed derivations against `repro`.

Tolerances: the hash bits, the uniforms and every seed are exact integers
and compared bitwise. z itself is held within 3 ulp: both packages compute
log, sqrt and cos in f32 with their own CPU math libraries (XLA's and
PyTorch's), each of which is up to 1 ulp from correctly rounded, and the
Box–Muller product compounds the three.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import zo as jzo  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import seeded_axpy as jsa  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import zo  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import seeded_axpy as sa  # noqa: E402
from repro_torch.models import registry  # noqa: E402

Z_ULPS = 3
SEEDS = [0, 7, 12345, 2**31 - 1]      # jax 0.9 overflows at seeds >= 2**31


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_bits_and_uniforms_exact(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    j_base = (jnp.asarray(idx) * jnp.uint32(2)
              + jnp.uint32(seed) * jnp.uint32(jsa._GOLDEN))
    j_bits = np.asarray(jsa.fmix32(j_base))
    t_base = (torch.from_numpy(idx.astype(np.int64)) * 2
              + sa.mul32(seed, sa.GOLDEN)) & sa.MASK32
    t_bits = sa.fmix32(t_base)
    np.testing.assert_array_equal(t_bits.numpy().astype(np.uint32), j_bits)
    np.testing.assert_array_equal(
        sa.bits_to_unit(t_bits).numpy(),
        np.asarray(jsa._bits_to_unit(jnp.asarray(j_bits))))


def test_mul32_full_uint32_range():
    """(x·c) mod 2³² without int64 overflow, up to x = c = 2³² − 1."""
    xs = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x846CA68B]
    for c in (sa.GOLDEN, 0x7FEB352D, 0x846CA68B, 2**32 - 1):
        t = sa.mul32(torch.tensor(xs, dtype=torch.int64), c)
        assert t.tolist() == [(x * c) % 2**32 for x in xs]
        assert [sa.mul32(x, c) for x in xs] == [(x * c) % 2**32 for x in xs]


@pytest.mark.parametrize("shape", [(300, 70), (8, 16, 33), (5000,), (64, 50),
                                   (1, 1), (2, 64, 48)])
@pytest.mark.parametrize("seed", [7, 2**31 - 5])
def test_z_within_ulps_of_draw_z_ref(shape, seed):
    z_ref = np.asarray(jref.draw_z_ref(shape, seed))
    z = sa.draw_z(shape, seed).numpy()
    assert z.shape == z_ref.shape
    assert _ulps(z, z_ref).max() <= Z_ULPS


_FIRST_DRAW = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import seeded_axpy as sa
first = sa.draw_z((300, 70), 7)
print(int((first != sa.draw_z((300, 70), 7)).sum()))
"""


def test_first_draw_in_a_fresh_process_is_thread_independent():
    """The first z draw of a fresh process equals a later one, bitwise.

    torch's CPU log/cos/sqrt run on MKL's vector math over OpenMP threads,
    and the first such call of a process returned one thread's chunk wrong
    (up to ~1600 ulp) in about 1 process in 13 started 8 at a time. 32
    fresh processes, each drawing first thing, would all but surely show it
    (P ≈ 0.92 at that rate)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    width = min(8, os.cpu_count() or 1)
    diffs = []
    for _ in range(32 // width):
        procs = [subprocess.Popen([sys.executable, "-c", _FIRST_DRAW, src],
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


def test_seeded_axpy_plain_matches_reference():
    """ops.seeded_axpy on a CPU tensor: out = w + scale·z, in and out of
    place (atol: 3 ulp of |z| ≤ 6 times |scale|, plus one ulp of w)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 96)).astype(np.float32)
    want = np.asarray(jref.seeded_axpy_ref(jnp.asarray(w), 99, 0.25))
    scale = torch.tensor(0.25, dtype=torch.float32)
    got = ops.seeded_axpy(torch.from_numpy(w), 99, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=0.25 * 6 * 3 * 2**-23 + 2**-20)
    wt = torch.from_numpy(w.copy())
    assert ops.seeded_axpy(wt, 99, scale, out=wt) is wt
    np.testing.assert_array_equal(wt.numpy(), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("t", [0, 1, 799, 2**31 - 1])
def test_seed_derivations_exact(seed, t):
    rs = zo.round_seed(seed, t)
    assert rs == int(jzo.round_seed(seed, t))
    for j in range(4):
        assert zo.perturb_seed(rs, j) == int(jzo.perturb_seed(np.uint32(rs), j))
    for i in (0, 1, 11, 12):
        assert zo.leaf_seed(rs, i) == int(jzo.leaf_seed(np.uint32(rs), i))


def test_full_uint32_seed_range_accepted():
    """The port takes the whole uint32 seed range (the reference overflows
    at seeds >= 2³¹ under jax 0.9): derivations stay in [0, 2³²)."""
    for s in (2**31, 2**32 - 1):
        rs = zo.round_seed(s, 3)
        assert 0 <= rs < 2**32
        assert 0 <= zo.leaf_seed(zo.perturb_seed(rs, 0), 5) < 2**32
        z = sa.draw_z((3, 5), s)
        assert torch.isfinite(z).all()


def _tiny() -> ModelConfig:
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                       head_dim=16)


@pytest.mark.parametrize("which", ["tiny", "opt-125m.reduced", "opt-125m"])
def test_flatten_order_and_shapes_match_jax(which):
    from repro.configs.base import ModelConfig as JModelConfig
    if which == "tiny":
        cfg = _tiny()
    elif which == "opt-125m.reduced":
        cfg = get_arch("opt-125m").reduced()
    else:
        cfg = get_arch("opt-125m")
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "head_dim")})
    jtree = jreg.abstract_params(jcfg, jnp.float32)
    jpaths = [(".".join(str(k.key) for k in path), tuple(leaf.shape))
              for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    meta = torch.device("meta")
    params = registry.init_params(cfg, prng.key(0), meta)
    ours = [(path, tuple(leaf.shape)) for path, leaf in zo.flatten(params)]
    assert ours == jpaths
    assert cfg.param_count() == jreg.count_params(jcfg)


def test_ops_dispatch_rejects_other_devices():
    """CPU tensors take the plain version; anything but cpu/cuda raises."""
    meta = torch.empty((4, 4), device="meta")
    scale = torch.tensor(1.0, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.seeded_axpy(meta, 1, scale)
    q = torch.empty((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.attention(q, q, q)


def test_cuda_build_flags():
    """Kernels build for sm_90a only, precise math (no --use_fast_math),
    as a plain-C shared library; the library name tracks the source."""
    from repro_torch.kernels import build
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-shared" in flags
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "torch/extension.h" not in src
        assert "cudaGetLastError" in src
        assert build.library_path(name).parent == build.BUILD_DIR
