"""The port's MLA attention (minicpm3-4b, deepseek-v2) and flash
attention at MLA's head dims against `repro` on the CPU.

Three MLA configurations, each package from the same seed:
- `minicpm3`: `minicpm3-4b.reduced()` (q·k head 16 + 8 = 24, v head 16,
  q_lora_rank 48);
- `deepseek`: `deepseek-v2-236b.reduced()` (the same MLA dims, MoE
  beside it);
- `qlora0`: minicpm3's reduced config with q_lora_rank 0 (the `wq`
  branch no shipped config uses).

Tolerances (f32 on both sides; only summation orders differ):
- `mla_attend`, train form and absorbed decode from a filled cache, and
  every cache leaf: rtol 1e-5, atol 1e-5;
- init: rtol 1e-6 (the port's normals are within 4 ulp of jax's,
  `test_torch_prng.py`);
- the plain attention at head_dim 24, 96 and 192 against
  `repro.kernels.ops.attention` (`xla`, and `pallas_interpret`, which
  pads to 128 or 256): rtol 1e-5, atol 1e-5.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 7
B, S = 2, 12


def _configs(name):
    arch = "deepseek-v2-236b" if name == "deepseek" else "minicpm3-4b"
    cfg, jcfg = get_arch(arch).reduced(), jreg.get_arch(arch).reduced()
    if name == "qlora0":
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=0))
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
            jcfg.mla, q_lora_rank=0))
    return cfg, jcfg


def _params(jcfg):
    """The reference's attention leaves of one layer (norm gains drawn
    away from 1, so they count), and the port's copy."""
    jp = JL.mla_init(jax.random.key(SEED), jcfg, jnp.float32)
    rng = np.random.default_rng(SEED)
    jp = {k: (jnp.asarray(1.0 + 0.1 * rng.standard_normal(v["g"].shape)
                          .astype(np.float32)) if k.endswith("norm")
              else v) for k, v in jp.items()}
    jp = {k: {"g": v} if k.endswith("norm") else v for k, v in jp.items()}
    tp = {k: ({"g": torch.from_numpy(np.array(v["g"]))}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    return jp, tp


def _x(cfg, s=S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", ["minicpm3", "deepseek", "qlora0"])
def test_mla_init_matches_reference(name):
    cfg, jcfg = _configs(name)
    want = JL.mla_init(jax.random.key(SEED), jcfg, jnp.float32)
    got = L.init_from_specs(L.mla_specs((), (), cfg), prng.key(SEED), "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        w = want[key]["g"] if isinstance(want[key], dict) else want[key]
        g = got[key]["g"] if isinstance(got[key], dict) else got[key]
        assert tuple(g.shape) == w.shape, key
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=key)


@pytest.mark.parametrize("name", ["minicpm3", "deepseek", "qlora0"])
def test_mla_attend_train_form_matches_reference(name):
    cfg, jcfg = _configs(name)
    jp, tp = _params(jcfg)
    x = _x(cfg)
    want, _ = JL.mla_attend(jp, jnp.asarray(x), jnp.arange(S), jcfg)
    got = L.mla_attend(tp, torch.from_numpy(x), torch.arange(S), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s_new", [1, 3])
@pytest.mark.parametrize("name", ["minicpm3", "deepseek", "qlora0"])
def test_mla_absorbed_decode_matches_reference(name, s_new):
    """s_new tokens at cache_pos 9 of a 16-slot latent cache whose first
    9 slots hold a prompt's latents and whose later slots hold stale
    values (masked by position, as the reference's): the output, and the
    cache written in place."""
    cfg, jcfg = _configs(name)
    jp, tp = _params(jcfg)
    m, pos, slots = cfg.mla, 9, 16
    rng = np.random.default_rng(3)
    ckv = rng.standard_normal((B, slots, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, slots, m.qk_rope_head_dim)).astype(
        np.float32)
    x = _x(cfg, s_new, seed=1)
    jpos = jnp.arange(s_new) + pos
    want, jcache = JL.mla_attend(
        jp, jnp.asarray(x), jpos, jcfg,
        kv_cache={"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope)},
        cache_pos=jnp.int32(pos))
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "krope": torch.from_numpy(krope.copy())}
    ptr = cache["ckv"].data_ptr()
    got = L.mla_attend(tp, torch.from_numpy(x), torch.arange(s_new) + pos,
                       cfg, kv_cache=cache, cache_pos=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["ckv"].data_ptr() == ptr
    for leaf in ("ckv", "krope"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), err_msg=leaf,
                                   **TOL)


@pytest.mark.parametrize("name", ["minicpm3", "deepseek"])
def test_mla_cache_shapes_match_reference(name):
    cfg, jcfg = _configs(name)
    got = transformer.init_cache(cfg, B, 20, device="cpu")
    want = jreg.get_module(jcfg).init_cache(jcfg, B, 20, dtype=jnp.float32)
    assert sorted(got) == sorted(want) == ["ckv", "krope"]
    for leaf in want:
        assert tuple(got[leaf].shape) == want[leaf].shape


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("d,hq,hkv", [(24, 4, 4), (96, 4, 4), (192, 2, 2),
                                      (96, 6, 2)])
def test_attention_plain_matches_reference_at_mla_head_dims(d, hq, hkv,
                                                            impl):
    """The plain version at MLA's q·k heads (reduced 24, minicpm3's 96,
    deepseek-v2's 192) with MLA's explicit scale, causal, Sq < Skv; the
    reference's Pallas path pads D to a multiple of 128."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, hq, 20, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, 28, d)).astype(np.float32)
            for _ in range(2))
    scale = 1.0 / np.sqrt(d - 8)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, scale=scale, impl=impl)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [24, 96, 192])
def test_flash_attention_cuda_takes_mla_head_dims(monkeypatch, d):
    """The reduced MLA head (24, padded to the 32 instance), minicpm3's 96
    and deepseek-v2's 192 pass every check of the CUDA wrapper and reach
    the library load (stopped there: no card here)."""
    def no_load(name):
        raise LookupError(f"library {name}")

    monkeypatch.setattr(build, "load", no_load)
    q = torch.zeros((2, 4, 16, d), device="meta")
    with pytest.raises(LookupError, match="flash_attention"):
        fa.flash_attention_cuda(q, q.clone(), q.clone())


def test_every_instance_is_launched_and_described():
    """Each head dim of SUPPORTED_HEAD_DIMS has a launch case and an
    attributes case in the CUDA source, and no other head dim has."""
    code = (build.CSRC / "flash_attention.cu").read_text()
    launch = re.findall(r"case (\d+): return launch_(?:small|tc|group)<\1>",
                        code)
    attrs = re.findall(r"case (\d+): return (?:small|tc|group)_attributes<\1>",
                       code)
    want = [str(d) for d in fa.SUPPORTED_HEAD_DIMS]
    assert launch == want and attrs == want
