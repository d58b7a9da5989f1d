"""The ported slice end to end: `repro_torch.core.fedsim.run` against
`repro.core.fedsim.run(engine="loop")`, plus the port's boundaries (no
jax/repro imports, GPU by default, unported options rejected).

Tolerances: per-round losses rtol 1e-4 over the 4-round trajectory (f32
differences compound through the updates); the DP ledger bitwise (host
float64, same left fold).
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs, jax_noise_rows  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_trace_noise(seed: int, t0: int, t1: int, n_perturb: int,
                    k: int) -> np.ndarray:
    """The reference's OTA normals for rounds [t0, t1), from the same round
    keys its control trace carries (fold_in(key(seed ^ 0x5EED), t))."""
    base_key = jax.random.key(seed ^ 0x5EED)
    return np.stack([jax_noise_rows(
        jax.random.key_data(jax.random.fold_in(base_key, t)), n_perturb, k)
        for t in range(t0, t1)])


def test_four_rounds_match_reference_loop_engine(monkeypatch):
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    jpipe = JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0)
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))

    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=4, engine="loop",
                      params=jparams, dtype=jnp.float32)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    seen = []
    res = fedsim.run(cfg, pz, pipe, rounds=4, params=params, device="cpu",
                     on_round=lambda t, m: seen.append(t))

    assert res.steps == ref.steps == 4 and seen == [0, 1, 2, 3]
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_array_equal(res.privacy_spent_per_round,
                                  ref.privacy_spent_per_round)
    assert res.privacy_spent == ref.privacy_spent
    assert res.privacy_budget == ref.privacy_budget
    assert res.uplink_bits == ref.uplink_bits
    assert res.privacy_exhausted_at == ref.privacy_exhausted_at == -1
    np.testing.assert_array_equal(res.schedule.c, ref.schedule.c)
    assert all(np.isfinite(res.p_hats))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax",
                               "ml_dtypes"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_cuda_is_the_default_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, pz = configs(base, n_perturb=1)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        fedsim.run(cfg, pz, pipe, rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        fedsim.run(cfg, pz, pipe, rounds=1, device="cuda")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--rounds", "1"])


def _bf16_unported(kwargs):
    """(cfg, pz, run kwargs) of a case: `fo` selects the FO transport,
    `model` a reduced arch in place of the tiny dense config."""
    kwargs = dict(kwargs)
    cfg, pz = configs(base, n_perturb=1)
    if kwargs.pop("fo", False):
        pz = base.PairZeroConfig(**{**pz.__dict__, "transport":
                                    base.TransportConfig(mechanism="fo")})
    if "model" in kwargs:
        from repro_torch.configs import get_arch
        cfg = get_arch(kwargs.pop("model")).reduced()
    return cfg, pz, kwargs


@pytest.mark.parametrize("kwargs", [
    dict(dtype=torch.float64), dict(dtype=torch.float16),
    dict(dtype=torch.bfloat16, fo=True),
    dict(mesh="8"), dict(dtype=torch.bfloat16, model="mamba2-370m"),
    dict(dtype=torch.bfloat16, checkpoint_dir="unwritten",
         checkpoint_every=1)])
def test_unported_options_raise(kwargs):
    """Since A12's first part (bf16 and impl= for the dense family) runs,
    what it does not hold against the reference raises naming its item:
    float16 and float64, the FO transport, the ssm family and checkpoints
    in bf16 (before any file is written); and mesh= (A11)."""
    cfg, pz, kwargs = _bf16_unported(kwargs)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fedsim.run(cfg, pz, pipe, rounds=1, device="cpu", **kwargs)
    assert not pathlib.Path("unwritten").exists()


@pytest.mark.parametrize("pz_kw,run_kw", [
    (dict(desync=base.DesyncConfig(fraction=0.5)),
     dict(mesh=object())),
    (dict(byzantine=base.ByzantineConfig(behavior="sign_flip",
                                         fraction=0.4)), dict(mesh="8")),
    ({}, dict(desync=object(), dtype=torch.float16)),
    ({}, dict(behavior=object(), dtype=torch.float64)),
    ({}, dict(dtype="float16"))])
def test_unported_config_fields_raise(pz_kw, run_kw):
    """The config's scenario fields and the run's scenario options are
    ported; beside them, the options that are not (mesh, a dtype other
    than float32 and bfloat16, also as a string) still raise naming their
    ROADMAP item."""
    cfg, pz = configs(base, n_perturb=1)
    pz = base.PairZeroConfig(**{**pz.__dict__, **pz_kw})
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fedsim.run(cfg, pz, pipe, rounds=1, device="cpu", **run_kw)


def test_cli_summary_on_cpu(capsys):
    from repro_torch.launch import train
    summary = train.main(["--reduced", "--rounds", "2", "--device", "cpu",
                          "--clients", "3", "--batch", "2", "--seq-len", "16",
                          "--n-perturb", "1"])
    assert summary["rounds"] == 2 and np.isfinite(summary["final_loss"])
    assert 0 < summary["privacy_spent"] <= summary["privacy_budget"]
    assert summary["uplink_bits"] == 2 * 3 * 16
    assert '"final_loss"' in capsys.readouterr().out


@pytest.mark.parametrize("kwargs,item", [
    (dict(dtype=jnp.float16), "A12"), (dict(dtype="float64"), "A12"),
    (dict(dtype=torch.float16), "A12"),
    (dict(dtype=jnp.bfloat16, model="recurrentgemma-2b"), "A12")])
def test_impl_and_dtype_raise_naming_their_item(kwargs, item):
    """A `dtype` the port does not hold against the reference (float16,
    float64; bf16 outside the dense family) raises NotImplementedError
    naming its ROADMAP item, not TypeError; `impl=` and bf16 of the dense
    family run (tests/test_torch_dtype.py)."""
    cfg, pz, kwargs = _bf16_unported(kwargs)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        fedsim.run(cfg, pz, pipe, rounds=1, device="cpu", **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, jnp.float32,
                                   "float32"])
def test_float32_dtype_is_accepted(dtype):
    cfg, pz = configs(base, n_perturb=1)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    res = fedsim.run(cfg, pz, pipe, rounds=1, device="cpu", dtype=dtype,
                     impl=None)
    assert res.steps == 1 and np.isfinite(res.losses).all()


@pytest.mark.parametrize("variant,scheme", [("sign", None),
                                            (None, "static"),
                                            ("analog", "perfect")])
def test_deprecated_variant_and_scheme_route_as_the_reference(
        variant, scheme, monkeypatch):
    """`variant=`/`scheme=` warn as the reference does and run the
    transport its `dataclasses.replace` selects; the port's run equals a
    run of the replaced config."""
    import dataclasses
    from repro_torch.core import transport as tp
    cfg, pz = configs(base, n_perturb=1)
    _, jpz = configs(jbase, n_perturb=1)
    seen = {}

    class Recorder:
        """Stands in for the reference's Experiment: keeps the config."""

        def __init__(self, model_cfg, pz, *args, **kwargs):
            seen["pz"] = pz

        def run(self):
            return None
    monkeypatch.setattr(jfedsim, "Experiment", Recorder)
    with pytest.warns(DeprecationWarning, match="fedsim.run"):
        jfedsim.run(configs(jbase, n_perturb=1)[0], jpz, None, rounds=1,
                    variant=variant, scheme=scheme)
    pipe = lambda: FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    with pytest.warns(DeprecationWarning, match="fedsim.run"):
        res = fedsim.run(cfg, pz, pipe(), rounds=2, device="cpu",
                         variant=variant, scheme=scheme)
    want = dataclasses.replace(
        pz, variant=variant or pz.variant,
        power=dataclasses.replace(pz.power, scheme=scheme or
                                  pz.power.scheme), transport=None)
    ref = seen["pz"]
    assert (want.variant, want.power.scheme, want.transport) == \
        (ref.variant, ref.power.scheme, ref.transport)
    assert res.transport == tp.resolve(want)
    again = fedsim.run(cfg, want, pipe(), rounds=2, device="cpu")
    assert res.losses == again.losses and res.p_hats == again.p_hats


@pytest.mark.parametrize("arch,fused", [
    ("minicpm3-4b", False), ("moonshot-v1-16b-a3b", False),
    ("moonshot-v1-16b-a3b", True), ("deepseek-v2-236b", False),
    ("deepseek-v2-236b", True)])
def test_four_rounds_of_the_mla_and_moe_configs_match_reference(
        monkeypatch, arch, fused):
    """Four loop rounds of the reduced MLA (minicpm3-4b) and MoE configs
    (moonshot; deepseek-v2 with MLA and a shared expert), chained and,
    for the moe family, fused, from the reference's weights."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg, jcfg = get_arch(arch).reduced(), jreg.get_arch(arch).reduced()
    _, pz = configs(base, n_perturb=2)
    _, jpz = configs(jbase, n_perturb=2)
    pz = dataclasses.replace(pz, fused_perturbation=fused)
    jpz = dataclasses.replace(jpz, fused_perturbation=fused)
    spec = (cfg.vocab_size, 24)
    jpipe = JPipe("sst2", JSpec("sst2", *spec), 5, 4, seed=0)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", *spec), 5, 4, seed=0)
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))

    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=4, engine="loop",
                      params=jparams, dtype=jnp.float32)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    res = fedsim.run(cfg, pz, pipe, rounds=4, params=params, device="cpu")
    assert res.steps == ref.steps == 4
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(res.p_hats, ref.p_hats, rtol=1e-4, atol=1e-3)
    assert res.privacy_spent == ref.privacy_spent
