"""The port's MoE layer (moonshot-v1-16b-a3b, deepseek-v2-236b) and the
configs of this slice against `repro` on the CPU.

Tolerances (f32 on both sides; the expert products and the combine sum
in another order than XLA's einsums and scatter-add):
- `moe` and the dispatch of one row: rtol 1e-5, atol 1e-5 · max|ref|
  (outputs near zero come from cancellation in the gated sum);
- init: rtol 1e-6 (normals within 4 ulp of jax's, `test_torch_prng.py`);
- configs and parameter counts: equal.

The capacity-overflow case is the reference's own dispatch: every
dropped (token, slot) pair is scattered onto expert 0's last slot with
token 0 and gate 0, and the later write wins, so a drop that follows the
pair filling that slot drops that pair too (ROADMAP, findings of the
reference). The port produces the same outputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402

SEED = 11
NEW_ARCHS = ["minicpm3-4b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
             "granite-34b", "deepseek-coder-33b"]
MOE_ARCHS = {"moonshot": "moonshot-v1-16b-a3b",
             "deepseek": "deepseek-v2-236b"}


def _assert_close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * np.abs(want).max())


def _configs(name):
    """Reduced moonshot, reduced deepseek-v2 (one shared expert), or
    moonshot's with dispatch groups of 8 over 24 tokens (three groups)."""
    arch = MOE_ARCHS.get(name, "moonshot-v1-16b-a3b")
    cfg, jcfg = get_arch(arch).reduced(), jreg.get_arch(arch).reduced()
    if name == "chunked":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, chunk=8))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, chunk=8))
    return cfg, jcfg


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("name", ["moonshot", "deepseek"])
def test_moe_init_matches_reference(name):
    cfg, jcfg = _configs(name)
    want = JL.moe_init(jax.random.key(SEED), jcfg, jnp.float32)
    got = L.init_from_specs(L.moe_specs((), (), cfg), prng.key(SEED), "cpu")
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    got_leaves, want_leaves = flat(got), flat(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert ("shared" in got) == (name == "deepseek")
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=str(path))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-236b"])
def test_model_init_matches_reference(arch):
    """`registry.init_params` of the whole reduced model, leaf for leaf in
    the reference's flattening order (the leaf seeds and counter streams
    of the ZO round depend on it)."""
    cfg, jcfg = get_arch(arch).reduced(), jreg.get_arch(arch).reduced()
    got = registry.init_params(cfg, prng.key(SEED), "cpu")
    want = jreg.init_params(jax.random.key(SEED), jcfg)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    got_leaves, want_leaves = flat(got), flat(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert registry.shapes(cfg) == tuple(w.shape for _, w in want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=str(path))


@pytest.mark.parametrize("name", ["moonshot", "deepseek", "chunked"])
def test_moe_matches_reference(name):
    """The whole layer on [3, 24, D] tokens at the reduced configs'
    capacity (so some tokens overflow their experts' queues)."""
    cfg, jcfg = _configs(name)
    jp = JL.moe_init(jax.random.key(SEED), jcfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (3, 24, cfg.d_model)).astype(np.float32)
    want = JL.moe(jp, jnp.asarray(x), jcfg)
    got = L.moe(_to_torch(jp), torch.from_numpy(x), cfg)
    _assert_close(got.numpy(), want)


def _row_params(rng, d, f, e):
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "we_i": rng.standard_normal((e, d, f)).astype(np.float32) / 3,
            "we_g": rng.standard_normal((e, d, f)).astype(np.float32) / 3,
            "we_d": rng.standard_normal((e, f, d)).astype(np.float32) / 4}


def _rows(p, x, e, k, cap):
    """Both packages' dispatch of each row of x [B, T, D]."""
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    want = np.stack([np.asarray(JL._moe_row(jp, jnp.asarray(r), e, k, cap))
                     for r in x])
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    xt = torch.from_numpy(x)
    got = L._moe_rows(tp, xt, (xt @ tp["router"]).float(), k, cap)
    return got.numpy(), want


def test_capacity_overflow_drops_as_reference():
    """e = 2, k = 1, cap = 2: tokens 0, 1, 2 go to expert 0 and token 3 to
    expert 1. Token 2 overflows; its drop lands on expert 0's last slot
    after token 1 filled it, so token 1 comes out zero as well, in both
    packages; tokens 0 and 3 are served."""
    rng = np.random.default_rng(0)
    d, e = 8, 2
    p = _row_params(rng, d, 16, e)
    p["router"][:] = 0.0
    p["router"][0] = [1.0, -1.0]
    x = rng.standard_normal((1, 4, d)).astype(np.float32)
    x[0, :, 0] = [5.0, 5.0, 5.0, -5.0]
    got, want = _rows(p, x, e, 1, 2)
    served = np.abs(want[0]).sum(-1) > 0
    assert served.tolist() == [True, False, False, True]
    assert (np.abs(got[0]).sum(-1) > 0).tolist() == served.tolist()
    _assert_close(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_with_overflow_matches_reference(seed):
    """Random routing of 10 tokens top-2 over 4 experts of capacity 3 in
    three rows: queues overflow, and expert 0's last slot is sometimes
    overwritten by a later drop."""
    rng = np.random.default_rng(100 + seed)
    d, e, k, cap = 8, 4, 2, 3
    p = _row_params(rng, d, 16, e)
    x = rng.standard_normal((3, 10, d)).astype(np.float32)
    got, want = _rows(p, x, e, k, cap)
    assert (np.abs(want).sum(-1) == 0).any()        # some token dropped
    _assert_close(got, want)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list(MOE_ARCHS.values()))
def test_active_param_count_matches_reference(arch, reduced):
    cfg, jcfg = get_arch(arch), jreg.get_arch(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for active in (False, True):
        assert registry.count_params(cfg, active_only=active) \
            == jreg.count_params(jcfg, active_only=active)
    assert registry.count_params(cfg, active_only=True) \
        < registry.count_params(cfg)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch):
    """Field for field (the MoE and MLA sub-configs too), the reduced
    variant's as well, and the parameter count."""
    ours, ref = get_arch(arch), jreg.get_arch(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) \
        == dataclasses.asdict(ref.reduced())
    assert ours.param_count() == jreg.count_params(ref)
