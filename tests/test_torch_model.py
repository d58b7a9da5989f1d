"""The port's attention and dense transformer against `repro` on the CPU.

Tolerances: attention rtol = atol = 1e-5 (both sides f32; the only
differences are summation orders). Per-client losses rtol 1e-5 from the
same weights (the reference's init, converted to tensors)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import zo  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ATTN_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window)
    (2, 4, 4, 24, 24, 16, True, None),
    (1, 8, 2, 16, 40, 32, True, None),      # GQA, Sq < Skv
    (2, 4, 1, 33, 33, 16, True, 8),         # MQA + local window
    (1, 2, 2, 12, 20, 64, False, None),     # non-causal, Sq < Skv
    # head_dim 256 (recurrentgemma-2b's): group 10 with a window and
    # Sq < Skv; group 3, non-causal, odd lengths
    (2, 10, 1, 24, 64, 256, True, 32),
    (1, 6, 2, 17, 17, 256, False, None),
]


def _qkv(case, seed=0):
    b, hq, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plain_matches_reference(case, impl):
    q, k, v = _qkv(case)
    causal, window = case[6], case[7]
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, impl=impl))
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _tiny() -> ModelConfig:
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                       head_dim=16)


def _jcfg(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "head_dim")})


def _batch(vocab, k=5, b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(k, b, s)).astype(np.int32)
    targets = rng.integers(0, vocab, size=(k, b, s)).astype(np.int32)
    mask = (rng.random((k, b, s)) < 0.5).astype(np.float32)
    return {"tokens": tokens, "targets": targets, "mask": mask}


@pytest.mark.parametrize("which", ["tiny", "opt-125m.reduced"])
def test_loss_per_client_matches_reference(which):
    cfg = _tiny() if which == "tiny" else get_arch("opt-125m").reduced()
    jcfg = _jcfg(cfg)
    jparams = jreg.init_params(jax.random.key(3), jcfg)
    batch = _batch(cfg.vocab_size)
    want = np.asarray(jtf.loss_per_client(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        impl="xla"))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tbatch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                  else v) for k, v in batch.items()}
    got = transformer.loss_per_client(params, cfg, tbatch)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_init_scales_match_reference():
    """The port's init has the reference's per-leaf scales: ones for the
    norms, std 0.02 for the tables, 1/sqrt(fan_in) for the projections
    (its values are the reference's too: `test_torch_prng.py`)."""
    cfg = get_arch("opt-125m").reduced()
    params = transformer.init(cfg, prng.key(0), torch.device("cpu"))
    jparams = jreg.init_params(jax.random.key(0), _jcfg(cfg))
    ours = dict(zo.flatten(params))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        name = ".".join(str(p.key) for p in path)
        ref_std, our_std = float(np.std(np.asarray(leaf))), float(
            ours[name].std())
        if ref_std == 0.0:
            assert torch.all(ours[name] == 1.0), name
        else:
            assert abs(our_std / ref_std - 1.0) < 0.15, name
