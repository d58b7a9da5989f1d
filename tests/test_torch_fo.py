"""The first-order baseline of the port (`repro_torch.optim.fo`,
`pairzero.make_fo_step`, the `fo` transport on both engines and the CLI)
against `repro`'s, and the differentiable kernel ops it runs through.

Tolerances:
- the optimizers over 3 steps: SGD, SGD with momentum and Adam rtol 1e-6
  with an atol of 1e-6 × max|param| (XLA's CPU compiler contracts
  `p − lr·g` and `b1·m + (1 − b1)·g` into fused multiply-adds and has its
  own f32 `pow`, so each op may round one ulp apart); signSGD bitwise
  (lr·sign(g) is exact);
- `make_fo_step`'s gradients against `jax.grad` of `repro`'s masked mean
  loss: per leaf, max|Δ| ≤ 1e-4 × max|g| + 1e-7 (f32 sums in another
  order through the forward and the backward);
- the 4-round FO trajectory against `repro`'s `fedsim.run`: losses rtol
  1e-4, as `test_torch_slice.py`;
- loop ≡ scan on the CPU, the CLI's two engines, and the kernel ops' vjp
  Function (run with the plain version as its "kernel") against autograd
  of the plain version: bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import pairzero as jpairzero  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import fo as jfo  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base, get_arch  # noqa: E402
from repro_torch.core import fedsim, pairzero, zo  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, rglru_scan  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import fo  # noqa: E402
from test_torch_round import _batch, configs  # noqa: E402


def _fo(mod, pz):
    return dataclasses.replace(pz, transport=mod.TransportConfig(
        mechanism="fo"))


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 2, 3)).astype(np.float32)]}


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.05)), ("sgd", dict(lr=0.05, momentum=0.9)),
    ("adam", dict(lr=0.01)), ("signsgd", dict(lr=0.01))])
def test_optimizers_match_reference_over_three_steps(name, kw):
    cls = {"sgd": "SGD", "adam": "Adam", "signsgd": "SignSGD"}[name]
    ours, ref = getattr(fo, cls)(**kw), getattr(jfo, cls)(**kw)
    host = _tree(0)
    params = params_from_numpy(host)
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    state, jstate = ours.init(params), ref.init(jparams)
    leaves = [t for _, t in zo.flatten(params)]
    for step in range(3):
        grads = _tree(10 + step)
        grads["b"][0][1] = 0.0               # an exact zero gradient
        params, state = ours.update(params, params_from_numpy(grads), state)
        jparams, jstate = ref.update(jparams, jax.tree_util.tree_map(
            jnp.asarray, grads), jstate)
    got = [t for _, t in zo.flatten(params)]
    assert all(a is b for a, b in zip(got, leaves))      # in place
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    for g, w in zip(got, want):
        if name == "signsgd":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
    if name == "adam":
        assert int(state["t"]) == int(jstate["t"]) == 3
        assert state["t"].dtype == torch.int32
        for moment in ("m", "v"):
            for g, w in zip([t for _, t in zo.flatten(state[moment])],
                            jax.tree_util.tree_leaves(jstate[moment])):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6)
    assert fo.make(name, 0.5) == getattr(fo, cls)(lr=0.5)


class _Keep:
    """An optimizer that keeps the gradients it is given."""

    def init(self, params):
        return ()

    def update(self, params, grads, state):
        self.grads = grads
        return params, state


def _models():
    tiny = configs(base)[0], configs(jbase)[0]
    ssm = (get_arch("mamba2-370m").reduced(),
           jreg.get_arch("mamba2-370m").reduced())
    hyb = (get_arch("recurrentgemma-2b").reduced(n_layers=5),
           jreg.get_arch("recurrentgemma-2b").reduced(n_layers=5))
    return {"dense": tiny, "ssm": ssm, "hybrid": hyb}


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_fo_step_gradients_match_jax_grad(family):
    cfg, jcfg = _models()[family]
    jparams = jreg.init_params(jax.random.key(2), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    batch = _batch(vocab=cfg.vocab_size)
    mask = np.array([1, 1, 0, 1, 1], np.float32)     # a dropped client
    jloss_fn = jpairzero.make_loss_fn(jcfg)

    def mean_loss(p):
        per_client = jloss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        return jnp.sum(per_client * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    jl, jg = jax.value_and_grad(mean_loss)(jparams)
    keep = _Keep()
    step = pairzero.make_fo_step(cfg, keep)
    tbatch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                  else v) for k, v in batch.items()}
    (new, _), metrics = step((params, ()), tbatch,
                             {"mask": torch.from_numpy(mask)})
    assert new is params and metrics["k_eff"] == 4.0
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    ours = zo.flatten(keep.grads)
    ref = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(ours) == len(ref)
    for (path, g), (_, w) in zip(ours, ref):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-7, (path, err)


def _pipes(spec=("sst2", 64, 24)):
    return (FederatedPipeline(spec[0], TaskSpec(*spec), 5, 4, seed=0),
            JPipe(spec[0], JSpec(*spec), 5, 4, seed=0))


def test_fo_trajectory_matches_reference():
    """4 rounds of FO-Adam from the same seed on both packages (nothing
    injected): losses rtol 1e-4, no privacy spent, 16·d bits a client."""
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    pz, jpz = _fo(base, pz), _fo(jbase, jpz)
    pipe, jpipe = _pipes()
    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=4, engine="loop",
                      dtype=jnp.float32)
    seen = []
    res = fedsim.run(cfg, pz, pipe, rounds=4, device="cpu",
                     on_round=lambda t, m: seen.append(sorted(m)))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    assert res.privacy_spent == ref.privacy_spent == 0.0
    assert res.uplink_bits == ref.uplink_bits == 16 * cfg.param_count() * 20
    assert res.p_hats == [] and seen == [["k_eff", "loss"]] * 4
    assert isinstance(res.transport, tp.FirstOrder)
    assert int(res.opt_state["t"]) == 4


def test_fo_loop_equals_scan_on_cpu():
    cfg, pz = configs(base, n_perturb=1)
    pz = _fo(base, pz)
    out = []
    for kw in (dict(), dict(engine="scan", chunk_rounds=3)):
        out.append(fedsim.run(cfg, pz, _pipes()[0], 5, device="cpu",
                              eval_every=2, eval_n=8, **kw))
    loop, scan = out
    assert scan.losses == loop.losses and scan.accuracies == loop.accuracies
    for tree in ("params", "m", "v"):
        a = loop.params if tree == "params" else loop.opt_state[tree]
        b = scan.params if tree == "params" else scan.opt_state[tree]
        for (path, x), (_, y) in zip(zo.flatten(a), zo.flatten(b)):
            assert torch.equal(x, y), (tree, path)


def test_fo_cli_loop_equals_scan():
    from repro_torch.launch import train
    args = ["--reduced", "--rounds", "3", "--device", "cpu", "--clients",
            "3", "--batch", "2", "--seq-len", "16", "--eval-every", "0",
            "--transport", "fo"]
    loop = train.main(args)
    scan = train.main(args + ["--engine", "scan", "--chunk-rounds", "2"])
    d = get_arch("opt-125m").reduced().param_count()
    assert loop["transport"] == "fo" and loop["privacy_spent"] == 0.0
    assert loop["uplink_bits"] == 16 * d * 3 * 3
    assert np.isfinite(loop["final_loss"])
    for key in ("final_loss", "uplink_bits", "rounds", "privacy_spent"):
        assert loop[key] == scan[key], key
    alias = train.main(args[:-2] + ["--variant", "fo"])
    assert alias["transport"] == "fo"
    assert alias["final_loss"] == loop["final_loss"]


def _grads_both_ways(fn_vjp, fn_plain, inputs):
    a = [t.clone().requires_grad_(True) for t in inputs]
    b = [t.clone().requires_grad_(True) for t in inputs]

    def loss(out):
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * o).sum() for o in outs if o is not None)

    ga = torch.autograd.grad(loss(fn_vjp(*a)), a)
    gb = torch.autograd.grad(loss(fn_plain(*b)), b)
    return ga, gb


@pytest.mark.parametrize("op", ["attention", "ssd-y", "ssd-state",
                                "linear_recurrence"])
def test_kernel_ops_vjp_is_the_plain_versions(op):
    """The Function the card runs when an input requires grad: its backward
    recomputes the plain version and returns that vjp. Run here with the
    plain version in the kernel's place, its grads equal autograd's of the
    plain version bitwise; without grad the ops take no Function."""
    g = torch.Generator().manual_seed(0)
    vjp = ops._KernelWithPlainVjp.apply
    if op == "attention":
        inputs = [torch.randn(2, 4, 9, 16, generator=g),
                  torch.randn(2, 2, 9, 16, generator=g),
                  torch.randn(2, 2, 9, 16, generator=g)]
        plain = fa.attention_plain
        args = (True, 5, None)
    elif op.startswith("ssd"):
        inputs = [torch.randn(2, 16, 3, 4, generator=g),
                  torch.rand(2, 16, 3, generator=g),
                  -torch.rand(3, generator=g),
                  torch.randn(2, 16, 5, generator=g),
                  torch.randn(2, 16, 5, generator=g)]
        plain = ops._ssd_plain
        args = (None, 8, op == "ssd-state")
    else:
        inputs = [torch.rand(2, 7, 5, generator=g),
                  torch.randn(2, 7, 5, generator=g)]
        plain = rglru_scan.linear_recurrence_plain
        args = (None,)
    n = len(inputs) + (1 if op.startswith("ssd") or op == "linear_recurrence"
                       else 0)
    ga, gb = _grads_both_ways(
        lambda *t: vjp(plain, plain, n, *t, *args),
        lambda *t: plain(*t, *args), inputs)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert not ops._needs_grad(*inputs)
    with torch.no_grad():
        assert not ops._needs_grad(inputs[0].requires_grad_(True))
    assert ops._needs_grad(inputs[0], None)


def test_fo_rejects_aggregate_and_prices_sixteen_bits():
    _, pz = configs(base, n_perturb=3)
    mech = tp.resolve(_fo(base, pz))
    assert mech.kind == "fo" and mech.draws == ()
    assert mech.payload_bits(pz, 1000) == 16_000
    assert mech.bits_per_round(pz, 1000) == 5 * 16_000
    assert not mech.charges_privacy(None, pz)
    assert tp.from_strings("fo", "solution") == mech
    with pytest.raises(NotImplementedError, match="no scalar uplink"):
        mech.aggregate(torch.zeros(5), {})
    params = registry.init_params(configs(base)[0], prng.key(0), "cpu")
    state = fo.Adam().init(params)
    assert all(float(t.abs().sum()) == 0.0 for _, t in zo.flatten(state))
