"""Checkpoints and resume of the port (`repro_torch.checkpoint`,
`fedsim.CheckpointHook`, the CLI's flags) against `repro` and against the
port's own uninterrupted runs.

Tolerances:
- files: bitwise both ways: a checkpoint `repro` writes restores into the
  port, and the reverse, with the same leaf names, CRCs, dtypes, shapes
  and values; the manifests of the same arrays are equal;
- a resumed run of the port (faults off) against its uninterrupted loop
  run: bitwise (losses, p̂, final weights, the DP ledger), on both engines
  with chunks that do not divide the cadence;
- a resumed run of the port against a resumed run of `repro`, faults on:
  masks bitwise, losses rtol 1e-4 (f32 differences compound through the
  updates, as in `test_torch_slice.py`), the DP ledger equal.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import dp as jdp  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import base, get_arch  # noqa: E402
from repro_torch.core import dp, engine, fedsim, zo  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from test_torch_fault import _record_masks  # noqa: E402
from test_torch_round import configs  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def params():
    return {"layer": {"w": torch.arange(12.0).reshape(3, 4),
                      "b": torch.ones(4)},
            "head": torch.full((2, 2), 7.0),
            "tail": [torch.zeros(3), {"g": torch.ones(2)}]}


def _zeros_like(tree):
    return {k: _zeros_like(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else [_zeros_like(v) for v in tree] \
        if isinstance(tree, list) else torch.zeros_like(tree)


def _equal_trees(a, b):
    la, lb = zo.flatten(a), zo.flatten(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path


# ---------------------------------------------------------------------------
# The files (the reference's own checks, on the port)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path, params):
    path = ckpt.save(str(tmp_path), 42, params,
                     extra={"accountant": {"spent": 0.5}})
    restored, step, extra = ckpt.restore(path, _zeros_like(params))
    assert step == 42 and extra["accountant"]["spent"] == 0.5
    _equal_trees(restored, params)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert sorted(data.files) == ["head", "layer/b", "layer/w",
                                      "tail/0", "tail/1/g"]


def test_latest_and_retention(tmp_path, params):
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, params, keep=3)
    assert ckpt.latest(str(tmp_path)).endswith("step_00000005")
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000004", "step_00000005"]


def test_corruption_detected(tmp_path, params):
    path = ckpt.save(str(tmp_path), 1, params)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz).items())
    first = sorted(data)[0]
    data[first] = data[first] + 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(path, _zeros_like(params))
    assert not ckpt.valid_checkpoint(path)


def test_shape_mismatch_detected(tmp_path, params):
    path = ckpt.save(str(tmp_path), 1, params)
    bad = _zeros_like(params)
    bad["layer"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, bad)


def test_latest_none_when_empty(tmp_path):
    assert ckpt.latest(str(tmp_path)) is None
    assert ckpt.latest(str(tmp_path / "missing")) is None
    assert ckpt.latest_valid(str(tmp_path / "missing")) is None


def test_manifest_is_valid_json(tmp_path, params):
    path = ckpt.save(str(tmp_path), 9, params, extra={"round": 9})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 9 and manifest["extra"] == {"round": 9}
    assert set(manifest["crc32"]) == set(manifest["shapes"]) \
        == set(manifest["dtypes"])
    assert manifest["dtypes"]["head"] == "float32"


@pytest.mark.parametrize("double_buffer", [True, False])
def test_async_checkpointer_roundtrip(tmp_path, params, double_buffer):
    acp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2,
                                 double_buffer=double_buffer)
    for step in (1, 2, 3):
        bumped = {"layer": {k: v + step for k, v in params["layer"].items()},
                  "head": params["head"] + step, "tail": params["tail"]}
        acp.save(step, bumped, extra={"round": step})
    acp.wait()
    restored, step, extra = ckpt.restore(ckpt.latest(str(tmp_path)),
                                         _zeros_like(params))
    assert step == 3 and extra["round"] == 3
    assert torch.equal(restored["head"], params["head"] + 3)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    assert acp.stall_s >= 0.0 and acp.write_failures == 0


@pytest.mark.parametrize("double_buffer", [True, False])
def test_snapshot_survives_the_next_in_place_update(tmp_path, params,
                                                    double_buffer):
    """The port's counterpart of the reference's donation test: the run
    updates the params in place right after `save` returns, long before
    the writer serializes; the checkpoint holds the values at `save`."""
    want = {p: t.clone() for p, t in zo.flatten(params)}
    acp = ckpt.AsyncCheckpointer(str(tmp_path), double_buffer=double_buffer)
    # a writer that waits until the update below has happened
    gate = threading.Event()
    real = acp._save_retrying

    def gated(*args):
        gate.wait(10)
        real(*args)
    acp._save_retrying = gated
    acp.save(1, params, extra={})
    for _, t in zo.flatten(params):
        t.mul_(2.0).add_(1.0)
    gate.set()
    acp.wait()
    restored, step, _ = ckpt.restore(ckpt.latest(str(tmp_path)),
                                     _zeros_like(params))
    assert step == 1
    for path, t in zo.flatten(restored):
        assert torch.equal(t, want[path]), path


def test_snapshot_buffers_are_reused(tmp_path, params):
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    acp.save(1, params)
    first = [b.data_ptr() for b in acp._buffers[1]]
    acp.save(2, params)
    acp.wait()
    assert [b.data_ptr() for b in acp._buffers[1]] == first


def test_async_writer_ioerror_keeps_last_good(tmp_path, params,
                                              monkeypatch):
    acp = ckpt.AsyncCheckpointer(str(tmp_path), write_retries=2)
    acp.save(1, params, extra={})
    acp.wait()

    def broken_save(*a, **kw):
        raise IOError("No space left on device")

    monkeypatch.setattr(ckpt, "save", broken_save)
    acp.save(2, params, extra={})
    acp.wait()
    assert acp.write_failures == 1
    assert acp.retries.get("ckpt_write", 0) == 1
    monkeypatch.undo()
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_00000001")
    _, step, _ = ckpt.restore(ckpt.latest_valid(str(tmp_path)),
                              _zeros_like(params))
    assert step == 1


def test_restore_rejects_torn_npz(tmp_path, params):
    path = ckpt.save(str(tmp_path), 3, params)
    ckpt.tear_checkpoint(path)
    with pytest.raises(Exception):
        ckpt.restore(path, _zeros_like(params))


def test_valid_checkpoint_and_latest_valid_walk(tmp_path, params):
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, params, keep=10)
    assert ckpt.valid_checkpoint(str(tmp_path / "step_00000004"))
    ckpt.tear_checkpoint(str(tmp_path / "step_00000004"))
    os.remove(tmp_path / "step_00000003" / "manifest.json")
    os.remove(tmp_path / "step_00000002" / "arrays.npz")
    assert not ckpt.valid_checkpoint(str(tmp_path / "step_00000004"))
    assert ckpt.latest(str(tmp_path)).endswith("step_00000004")
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_00000001")
    assert jckpt.latest_valid(str(tmp_path)) == \
        ckpt.latest_valid(str(tmp_path))
    ckpt.tear_checkpoint(str(tmp_path / "step_00000001"))
    assert ckpt.latest_valid(str(tmp_path)) is None


def test_weights_are_freed_without_the_garbage_collector(tmp_path, params):
    """Neither `save`, `restore` nor the checkpointer leaves a reference
    cycle holding the weights: on the card such a cycle keeps θ allocated
    until a collection happens to run."""
    import gc
    import weakref
    gc.disable()
    try:
        acp = ckpt.AsyncCheckpointer(str(tmp_path))
        acp.save(1, params)
        acp.wait()
        restored, _, _ = ckpt.restore(ckpt.latest(str(tmp_path)),
                                      _zeros_like(params))
        refs = [weakref.ref(t) for _, t in zo.flatten(params)] + \
            [weakref.ref(t) for _, t in zo.flatten(restored)]
        del restored
        params.clear()
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_numpy_params_snapshot(tmp_path):
    host = {"w": np.arange(6.0).reshape(2, 3)}
    acp = ckpt.AsyncCheckpointer(str(tmp_path), double_buffer=True)
    acp.save(5, host, extra={})
    host["w"] += 1.0                          # the snapshot is a copy
    acp.wait()
    restored, step, _ = ckpt.restore(ckpt.latest(str(tmp_path)),
                                     {"w": np.zeros((2, 3))})
    assert step == 5
    np.testing.assert_array_equal(restored["w"], np.arange(6.0).reshape(2, 3))


def test_accountant_state_dict_matches_reference():
    ours = dp.PrivacyAccountant(5.0, 0.01)
    ref = jdp.PrivacyAccountant(5.0, 0.01)
    costs = np.random.default_rng(0).random(7) * 0.01
    ours.spend_batch(costs)
    ref.spend_batch(costs)
    assert ours.state_dict() == ref.state_dict()
    back = dp.PrivacyAccountant.from_state_dict(ref.state_dict())
    assert back.spent == ref.spent and back.history == []
    assert back.budget == jdp.PrivacyAccountant.from_state_dict(
        ours.state_dict()).budget


# ---------------------------------------------------------------------------
# Cross-load: the same files in both packages
# ---------------------------------------------------------------------------

def _model(family):
    cfg, _ = configs(base)
    jcfg, _ = configs(jbase)
    if family == "hybrid":
        cfg = get_arch("recurrentgemma-2b").reduced()
        jcfg = jreg.get_arch("recurrentgemma-2b").reduced()
    return (cfg, registry.init_params(cfg, prng.key(1), CPU),
            jreg.init_params(jax.random.key(1), jcfg))


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, family):
    cfg, params, jparams = _model(family)
    path = jckpt.save(str(tmp_path), 7, jparams, extra={"round": 7})
    restored, step, extra = ckpt.restore(path, _zeros_like(params))
    assert step == 7 and extra == {"round": 7}
    names, leaves = ckpt._leaf_paths(restored)
    jnames, jleaves, _ = jckpt._leaf_paths(jparams)
    assert names == jnames
    for n, a, b in zip(names, leaves, jleaves):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=n)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, family):
    cfg, params, jparams = _model(family)
    path = ckpt.save(str(tmp_path), 3, params, extra={"round": 3})
    like = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    restored, step, extra = jckpt.restore(path, like)
    assert step == 3 and extra == {"round": 3}
    for (n, a), b in zip(zo.flatten(params),
                         jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=n)


def test_manifests_of_the_same_arrays_are_equal(tmp_path):
    cfg, params, jparams = _model("hybrid")
    host = jax.tree_util.tree_map(np.asarray, jparams)
    ours = ckpt.save(str(tmp_path / "port"), 5, _from_numpy(host),
                     extra={"round": 5})
    ref = jckpt.save(str(tmp_path / "ref"), 5, jparams, extra={"round": 5})
    manifests = []
    for path in (ours, ref):
        with open(os.path.join(path, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["crc32"]) == list(manifests[1]["crc32"])
    with np.load(os.path.join(ours, "arrays.npz")) as a, \
            np.load(os.path.join(ref, "arrays.npz")) as b:
        assert a.files == b.files
        for n in a.files:
            np.testing.assert_array_equal(a[n], b[n])


def _from_numpy(tree):
    if isinstance(tree, dict):
        return {k: _from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------

def _pipe():
    return FederatedPipeline("sst2", TaskSpec("sst2", 64, 24), 5, 4, seed=0)


@pytest.fixture(scope="module")
def uninterrupted():
    """8 rounds on the loop engine, an elastic event at round 4."""
    cfg, pz = configs(base, n_perturb=2)
    return fedsim.run(cfg, pz, _pipe(), 8, device="cpu", eval_every=2,
                      eval_n=8, elastic=fault.ElasticSchedule(5, ((4, 3),)))


@pytest.mark.parametrize("engine_name,chunk", [("loop", 32), ("scan", 3),
                                               ("scan", 5)])
def test_resume_equals_uninterrupted_bitwise(tmp_path, uninterrupted,
                                             engine_name, chunk):
    cfg, pz = configs(base, n_perturb=2)
    kw = dict(device="cpu", engine=engine_name, chunk_rounds=chunk,
              eval_every=2, eval_n=8, checkpoint_dir=str(tmp_path),
              elastic=fault.ElasticSchedule(5, ((4, 3),)))
    first = fedsim.run(cfg, pz, _pipe(), 4, checkpoint_every=4, **kw)
    assert first.resumed_from == 0 and first.steps == 4
    res = fedsim.run(cfg, pz, _pipe(), 8, checkpoint_every=3, **kw)
    ref = uninterrupted
    assert res.resumed_from == 4 and res.steps == 4
    assert res.losses == ref.losses[4:] and res.p_hats == ref.p_hats[4:]
    assert res.accuracies == ref.accuracies[2:]
    np.testing.assert_array_equal(res.privacy_spent_per_round,
                                  ref.privacy_spent_per_round[4:])
    assert res.privacy_spent == ref.privacy_spent
    assert first.uplink_bits + res.uplink_bits == ref.uplink_bits
    _equal_trees(res.params, ref.params)
    assert res.retry_attempts == {} and res.ckpt_stall_s > 0
    # the resumed run saved at 6 (its cadence of 3) and at nothing else
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000006"]


def test_resume_of_a_completed_run_executes_no_round(tmp_path):
    cfg, pz = configs(base, n_perturb=1)
    kw = dict(device="cpu", checkpoint_dir=str(tmp_path), checkpoint_every=2)
    done = fedsim.run(cfg, pz, _pipe(), 4, **kw)
    again = fedsim.run(cfg, pz, _pipe(), 4, engine="scan", **kw)
    assert again.resumed_from == 4 and again.steps == 0
    assert again.losses == [] and again.uplink_bits == 0
    assert again.privacy_spent == done.privacy_spent
    assert len(again.privacy_spent_per_round) == 0
    _equal_trees(again.params, done.params)


def test_resumed_run_stops_at_the_privacy_budget(tmp_path):
    """A checkpoint whose ledger affords exactly 3 more rounds: both
    engines stop at round 5 + 3 mid-chunk, charging nothing past it."""
    cfg, pz = configs(base, n_perturb=1)
    pz = base.PairZeroConfig(**{**pz.__dict__, "rounds": 12,
                                "power": base.PowerControlConfig(
                                    scheme="static")})
    probe = fedsim.run(cfg, pz, _pipe(), 12, device="cpu")
    costs = np.diff(np.concatenate(([0.0], probe.privacy_spent_per_round)))
    budget = dp.r_dp(pz.dp.epsilon, pz.dp.delta)
    spent = budget - costs[5:8].sum() - 0.5 * costs[8]
    out = {}
    for name in ("loop", "scan"):
        d = str(tmp_path / name)
        ckpt.save(d, 5, registry.init_params(cfg, prng.key(0), CPU),
                  extra={"accountant": {"epsilon": pz.dp.epsilon,
                                        "delta": pz.dp.delta,
                                        "spent": spent}, "round": 5})
        out[name] = fedsim.run(cfg, pz, _pipe(), 12, device="cpu",
                               engine=name, chunk_rounds=8,
                               checkpoint_dir=d)
    for res in out.values():
        assert res.resumed_from == 5 and res.privacy_exhausted_at == 8
        assert res.steps == 3 and len(res.losses) == 3
        assert res.privacy_spent <= budget * (1 + 1e-6)
    assert out["loop"].losses == out["scan"].losses


def test_faulted_resume_matches_reference(tmp_path, monkeypatch):
    """Faults on, each package interrupted at 4 and resumed to 8 with a
    fresh FaultModel: the resumed masks are the reference's bitwise, and
    a fresh model drawn from round 4 (the generator restarts at the
    resume, in the reference as here)."""
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    fkw = dict(dropout_p=0.3, straggler_p=0.1, seed=9)
    es = ((4, 3),)
    jpipe = lambda: JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0)
    jdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    for rounds, every in ((4, 4), (8, 100)):
        jseen = _record_masks(monkeypatch, jeng)
        ref = jfedsim.run(jcfg, jpz, jpipe(), rounds=rounds, engine="loop",
                          checkpoint_dir=jdir, checkpoint_every=every,
                          fault=jfault.FaultModel(5, **fkw),
                          elastic=jfault.ElasticSchedule(5, es),
                          dtype=jnp.float32)
        seen = _record_masks(monkeypatch, engine)
        res = fedsim.run(cfg, pz, _pipe(), rounds, device="cpu",
                         checkpoint_dir=pdir, checkpoint_every=every,
                         fault=fault.FaultModel(5, **fkw),
                         elastic=fault.ElasticSchedule(5, es))
        monkeypatch.undo()
    assert res.resumed_from == ref.resumed_from == 4
    masks = np.concatenate(seen)
    np.testing.assert_array_equal(masks, np.concatenate(jseen))
    fresh = fault.FaultModel(5, **fkw)
    np.testing.assert_array_equal(masks, np.stack([
        fault.combined_mask(t, fresh, fault.ElasticSchedule(5, es),
                            n_clients=5) for t in range(4, 8)]))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


def test_fo_resume_restarts_adam(tmp_path):
    """Under FO the checkpoint holds the params only (as the reference's
    does): the resumed run's Adam state counts only its own 3 steps, and
    its rounds equal a fresh FO run from the restored params over rounds
    5-7 (same batches, same everything but the round index, which FO's
    step does not read)."""
    cfg, pz = configs(base, n_perturb=1)
    pz = base.PairZeroConfig(**{**pz.__dict__, "transport":
                                base.TransportConfig(mechanism="fo")})
    d = str(tmp_path)
    fedsim.run(cfg, pz, _pipe(), 5, device="cpu", checkpoint_dir=d,
               checkpoint_every=5)
    res = fedsim.run(cfg, pz, _pipe(), 8, device="cpu", checkpoint_dir=d,
                     checkpoint_every=100)
    assert res.resumed_from == 5 and int(res.opt_state["t"]) == 3
    restored, _, _ = ckpt.restore(ckpt.latest_valid(d),
                                  registry.init_params(cfg, prng.key(0),
                                                       CPU))

    class Skip(FederatedPipeline):
        def batch(self, t):
            return super().batch(t + 5)
    fresh = fedsim.run(cfg, pz, Skip("sst2", TaskSpec("sst2", 64, 24), 5, 4,
                                     seed=0), 3, device="cpu",
                       params=restored)
    assert res.losses == fresh.losses
    _equal_trees(res.params, fresh.params)


def test_cli_resumes_and_a_completed_run_does_nothing(tmp_path, capsys):
    argv = ["--reduced", "--rounds", "4", "--device", "cpu", "--clients",
            "3", "--batch", "2", "--seq-len", "16", "--n-perturb", "1",
            "--eval-every", "0", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2", "--dropout-p", "0.2",
            "--elastic", "2:2", "--inject", "ckpt_write:torn_write:@1"]
    first = train.main(argv)
    assert first["resumed_from"] == 0 and first["rounds"] == 4
    assert first["injected"] == {"ckpt_write": 1}
    assert first["retry_attempts"] == {} and first["ckpt_stall_s"] >= 0
    # step 4 is torn: the re-run resumes at 2
    again = train.main(argv[:-2])
    assert again["resumed_from"] == 2 and again["rounds"] == 2
    done = train.main(argv[:-2])
    assert done["resumed_from"] == 4 and done["rounds"] == 0
    assert done["final_loss"] is None and done["uplink_bits"] == 0
    assert '"resumed_from": 4' in capsys.readouterr().out


def test_cli_checkpoint_and_fault_flags_match_reference():
    ours = {a.dest: a.default for a in train.build_parser()._actions}
    ref = {a.dest: a.default for a in jtrain.build_parser()._actions}
    for dest in ("checkpoint_dir", "checkpoint_every", "dropout_p",
                 "straggler_p", "elastic", "inject", "inject_seed"):
        assert ours[dest] == ref[dest], dest


def test_example_resumes_on_rerun(tmp_path, capsys):
    from repro_torch.examples import federated_finetune as ex
    argv = ["--device", "cpu", "--rounds", "6", "--ckpt", str(tmp_path),
            "--engine", "scan", "--chunk-rounds", "4"]
    first = ex.main(argv)
    assert first.resumed_from == 0 and first.steps == 6
    assert np.isfinite(first.losses).all() and len(first.accuracies) == 6
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000002", "step_00000004", "step_00000006"]
    again = ex.main(argv)
    assert again.resumed_from == 6 and again.steps == 0
    assert "resumed at round 6" in capsys.readouterr().out
