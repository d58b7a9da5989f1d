"""The port's scan engine, chunk prefetch and eval hook against its loop
engine and against `repro`.

Tolerances:
- scan against loop inside the port: bitwise (losses, p̂, final weights,
  accuracies and the DP ledger), for chunks of 1, 3 and 4 rounds with the
  prefetch thread on and off: on the CPU both engines run the same round
  body eagerly on the same inputs;
- the port's scan against `repro`'s scan over 8 rounds in chunks of 4,
  `repro`'s OTA normals injected: losses rtol 1e-4 (f32 differences
  compound through the updates, as in `test_torch_slice.py`); the DP
  ledger bitwise (host float64, same left fold);
- the control trace's leaf seeds, `eval_batch` and the chunk boundaries:
  bitwise / equal;
- eval logits at the last position against `repro`'s `EvalHook` function
  on the same weights and batch: rtol 1e-5, and atol 1e-5·max|ref| for
  the logits near 0 (f32 sums in another order); the accuracies equal.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import channel, prng  # noqa: E402
from repro_torch.configs import base, get_arch  # noqa: E402
from repro_torch.core import engine, fedsim, transport, zo  # noqa: E402
from repro_torch.data import tasks  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import seeded_axpy as sa  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs  # noqa: E402
from test_torch_slice import jax_trace_noise  # noqa: E402

CPU = torch.device("cpu")


def _pipe(vocab=64, seq=24, k=5, b=4):
    return FederatedPipeline("sst2", TaskSpec("sst2", vocab, seq), k, b,
                             seed=0)


def _weights(cfg, seed=3):
    return registry.init_params(cfg, prng.key(seed), CPU)


def _same_run(a, b):
    assert a.losses == b.losses and a.p_hats == b.p_hats
    assert a.accuracies == b.accuracies
    np.testing.assert_array_equal(a.privacy_spent_per_round,
                                  b.privacy_spent_per_round)
    assert a.privacy_spent == b.privacy_spent
    assert a.uplink_bits == b.uplink_bits
    assert a.privacy_exhausted_at == b.privacy_exhausted_at
    for (path, x), (_, y) in zip(zo.flatten(a.params), zo.flatten(b.params)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_scan_equals_loop_bitwise(chunk, overlap):
    cfg, pz = configs(base, n_perturb=2)
    loop = fedsim.run(cfg, pz, _pipe(), 8, params=_weights(cfg),
                      device="cpu", eval_every=4)
    scan = fedsim.run(cfg, pz, _pipe(), 8, params=_weights(cfg),
                      device="cpu", engine="scan", chunk_rounds=chunk,
                      overlap=overlap, eval_every=4)
    assert scan.steps == 8 and len(scan.accuracies) == 2
    assert scan.prep_stall_s >= 0.0
    _same_run(scan, loop)


def test_scan_equals_loop_bitwise_opt125m_reduced():
    cfg = get_arch("opt-125m").reduced()
    _, pz = configs(base, n_perturb=1)
    pipe = lambda: _pipe(cfg.vocab_size, 16, 5, 2)  # noqa: E731
    loop = fedsim.run(cfg, pz, pipe(), 8, params=_weights(cfg),
                      device="cpu")
    scan = fedsim.run(cfg, pz, pipe(), 8, params=_weights(cfg),
                      device="cpu", engine="scan", chunk_rounds=4)
    _same_run(scan, loop)


def test_scan_matches_reference_scan(monkeypatch):
    cfg, pz = configs(base, n_perturb=2)
    jcfg, jpz = configs(jbase, n_perturb=2)
    jpipe = JPipe("sst2", JSpec("sst2", 64, 24), 5, 4, seed=0)
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ref = jfedsim.run(jcfg, jpz, jpipe, rounds=8, engine="scan",
                      chunk_rounds=4, params=jparams, dtype=jnp.float32)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    seen = []
    res = fedsim.run(cfg, pz, _pipe(), 8, params=params, device="cpu",
                     engine="scan", chunk_rounds=4,
                     on_round=lambda t, m: seen.append(t))
    assert res.steps == ref.steps == 8 and seen == list(range(8))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_array_equal(res.privacy_spent_per_round,
                                  ref.privacy_spent_per_round)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits


@pytest.mark.parametrize("base_seed", [0, 12345, 2**31 - 1])
def test_leaf_seeds_match_reference(base_seed):
    """ctl["leaf_seeds"][r, j, i] is repro's leaf_seed(perturb_seed(
    round_seed(seed, t), j), i) for every leaf (seeds below 2³¹: ROADMAP
    C1), held as int32 bits."""
    cfg, pz = configs(base, n_perturb=3)
    pz = base.PairZeroConfig(**{**pz.__dict__, "seed": base_seed})
    n_leaves = len(registry.shapes(cfg))
    sched = transport.resolve(pz).make_schedule(
        channel.from_config(pz.channel).realize(
            base_seed ^ 0xC4A7, pz.rounds, pz.n_clients), pz)
    trace = engine.build_trace(sched, pz, 2, 7, device=CPU,
                               n_leaves=n_leaves)
    got = trace.ctl["leaf_seeds"].numpy().view(np.uint32)
    ts = jnp.arange(2, 7, dtype=jnp.uint32)
    rs = jzo.round_seed(base_seed, ts)
    for j in range(3):
        ps = jzo.perturb_seed(rs, j)
        for i in range(n_leaves):
            np.testing.assert_array_equal(got[:, j, i],
                                          np.asarray(jzo.leaf_seed(ps, i)))
    np.testing.assert_array_equal(trace.ctl["seed"], np.asarray(rs))
    row = zo.seed_row(int(jzo.perturb_seed(rs[0], 1)), n_leaves)
    np.testing.assert_array_equal(row.numpy().view(np.uint32), got[0, 1])


@pytest.mark.parametrize("start,stop,chunk,align", [
    (0, 10, 4, ()), (0, 10, 4, (3,)), (3, 17, 5, (4, 6)), (0, 7, 32, (2,)),
    (5, 6, 8, (5,)), (0, 12, 1, (4,))])
def test_chunk_boundaries_match_reference(start, stop, chunk, align):
    got = engine.chunk_boundaries(start, stop, chunk, align)
    assert got == jeng.chunk_boundaries(start, stop, chunk, align)
    assert got[0][0] == start and got[-1][1] == stop
    for (a, b), (c, _) in zip(got, got[1:]):
        assert b == c and b - a <= chunk
    cuts = {b for _, b in got}
    for p in align:
        assert all(m in cuts for m in range(p, stop, p) if m > start)


def test_batch_stager_slots_and_lifetime():
    """Each staged chunk equals pipeline.batch (labels dropped, int64
    tokens). With two slots the third chunk refills slot 0 in place: on
    the CPU the first chunk's tensors alias that buffer, so they now show
    the third chunk's rows — the lifetime the driver's kick/get handshake
    respects."""
    pipe = _pipe(seq=16, k=3, b=2)
    stager = engine.BatchStager(pipe, CPU, slots=2)
    staged, blocks = [], []
    for a in (0, 4, 8):
        out = stager.stage(a, a + 4)
        assert "labels" not in out and out["tokens"].dtype == torch.int64
        for r in range(4):
            want = pipe.batch(a + r)
            for key, v in out.items():
                np.testing.assert_array_equal(v[r].numpy(), want[key])
        staged.append({k: v.clone() for k, v in out.items()})
        blocks.append(stager._slots[(a // 4) % 2])
        if a == 0:
            first = out
    assert blocks[0] is blocks[2] and blocks[0] is not blocks[1]
    for key in first:
        assert torch.equal(first[key], staged[2][key])
    one = engine.stack_batches(pipe, 4, 8, CPU)
    for key in one:
        assert torch.equal(one[key], staged[1][key])


def test_chunk_prefetcher_kick_get_contract():
    seen = []

    def prepare(a, b):
        seen.append((a, b))
        return (a, b)

    bounds = [(0, 3), (3, 6), (6, 8)]
    pf = engine.ChunkPrefetcher(prepare, bounds, overlap=True)
    try:
        pf.kick(1)                        # not next: ignored
        assert pf.get(0) == (0, 3)        # nothing kicked: inline
        pf.kick(1)
        pf.kick(1)                        # double kick: no-op
        assert pf.get(1) == (3, 6)
        assert pf.get(2) == (6, 8)        # never kicked: inline
        assert seen == bounds             # round order preserved
        assert pf.stall_s >= 0.0 and pf.degraded == 0
        with pytest.raises(ValueError, match="in order"):
            pf.get(1)
    finally:
        pf.close()


def test_chunk_prefetcher_reruns_a_failed_kick_once():
    calls = []

    def prepare(a, b):
        calls.append((a, b))
        if len(calls) == 2:               # the kicked preparation fails
            raise RuntimeError("boom")
        if len(calls) == 4:               # and chunk 2's inline re-run too
            raise RuntimeError("again")
        return (a, b)

    pf = engine.ChunkPrefetcher(prepare, [(0, 1), (1, 2), (2, 3)])
    try:
        assert pf.get(0) == (0, 1)
        pf.kick(1)
        assert pf.get(1) == (1, 2) and pf.degraded == 1
        assert calls == [(0, 1), (1, 2), (1, 2)]
        with pytest.raises(RuntimeError, match="again"):
            pf.get(2)                     # inline: a failure propagates
    finally:
        pf.close()


class _NearlySpent(fedsim.RoundHook):
    """Starts the run with the ledger `affordable` rounds (and half of the
    next) short of the budget, as a resumed run finds it."""

    def __init__(self, affordable):
        self.affordable = affordable

    def on_start(self, exp):
        costs = exp.transport.round_dp_costs(exp.result.schedule, 0,
                                             self.affordable + 1, exp.pz)
        exp.accountant.spent = (exp.accountant.budget
                                - float(np.sum(costs[:self.affordable]))
                                - 0.5 * float(costs[self.affordable]))


def test_privacy_stop_mid_chunk():
    """The budget dies inside a chunk of 8: the scan engine stops at the
    round the loop engine stops at, every executed round charged."""
    cfg, pz = configs(base, n_perturb=1)
    out = {}
    for eng in ("loop", "scan"):
        out[eng] = fedsim.run(cfg, pz, _pipe(), 12, params=_weights(cfg),
                              device="cpu", engine=eng, chunk_rounds=8,
                              hooks=[_NearlySpent(3)])
    loop, scan = out["loop"], out["scan"]
    assert loop.privacy_exhausted_at == scan.privacy_exhausted_at == 3
    assert len(scan.losses) == scan.steps == 3
    assert scan.privacy_spent_per_round.size == 3
    assert scan.privacy_spent <= scan.privacy_budget * (1 + 1e-6)
    _same_run(scan, loop)


def test_privacy_stop_at_chunk_head():
    """Nothing affordable: the scan engine stops before dispatching."""
    cfg, pz = configs(base, n_perturb=1)
    res = fedsim.run(cfg, pz, _pipe(), 12, params=_weights(cfg),
                     device="cpu", engine="scan", chunk_rounds=8,
                     hooks=[_NearlySpent(0)])
    assert res.privacy_exhausted_at == 0
    assert res.losses == [] and res.steps == 0


@pytest.mark.parametrize("seed", [0, 99, 2**31 + 5, 2**32 - 1])
def test_seed_by_value_plain_paths_unchanged(seed):
    """The plain versions take the seed as a host int, as before; the
    dispatch on a CPU tensor reads a device seed's uint32 bits back, and
    both equal `repro`'s plain reference draw (seeds below 2³¹)."""
    w = np.random.default_rng(seed % 1000).standard_normal(
        (3, 70)).astype(np.float32)
    scale = torch.tensor(-0.25)
    st = sa.seed_tensor(seed)
    assert st.dtype == torch.int32 and st.numel() == 1
    assert sa.seed_value(st) == seed
    plain = sa.seeded_axpy_plain(torch.from_numpy(w), seed, scale)
    assert torch.equal(ops.seeded_axpy(torch.from_numpy(w), st, scale), plain)
    pp = ops.PerturbedParam(torch.from_numpy(w), st, 5, scale)
    assert torch.equal(ops.resolve(pp),
                       sa.seeded_axpy_plain(torch.from_numpy(w), seed, scale,
                                            5))
    if seed < 2**31:
        z = np.asarray(jref.draw_z_ref((3, 70), seed))
        got = sa.draw_z((3, 70), sa.seed_value(st)).numpy()
        assert np.abs(got.view(np.int32).astype(np.int64)
                      - z.view(np.int32).astype(np.int64)).max() <= 4


def test_kernel_wrappers_take_no_host_seed():
    """On the card the seed is read from device memory: a host int is
    refused before any library load."""
    w = torch.zeros((4, 4), device="meta")
    scale = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="seed must be one int32"):
        sa.seeded_axpy_cuda(w, 5, scale, w)
    with pytest.raises(ValueError, match="seed must be one int32"):
        sa.seeded_gather_cuda(w, torch.zeros(2, dtype=torch.int64,
                                             device="meta"), 5, scale)


FAMILIES = {
    "dense": lambda: (get_arch("opt-125m").reduced(),
                      jreg.get_arch("opt-125m").reduced()),
    "ssm": lambda: (get_arch("mamba2-370m").reduced(),
                    jreg.get_arch("mamba2-370m").reduced()),
    "hybrid": lambda: (get_arch("recurrentgemma-2b").reduced(n_layers=5),
                       jreg.get_arch("recurrentgemma-2b").reduced(
                           n_layers=5)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_hook_matches_reference(family):
    cfg, jcfg = FAMILIES[family]()
    jparams = jreg.init_params(jax.random.key(7), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", cfg.vocab_size, 16),
                             3, 2, seed=5)
    jpipe = JPipe("sst2", JSpec("sst2", cfg.vocab_size, 16), 3, 2, seed=5)
    ebatch = pipe.eval_batch(16)
    for key, v in jpipe.eval_batch(16).items():
        np.testing.assert_array_equal(ebatch[key], v)

    jhook = jfedsim.EvalHook(1, eval_n=16)
    jexp = types.SimpleNamespace(model_cfg=jcfg, impl="xla",
                                 dtype=jnp.float32, pipeline=jpipe,
                                 params=jparams,
                                 result=types.SimpleNamespace(accuracies=[]))
    jhook.on_start(jexp)
    ref = np.asarray(jhook._fn(jparams, ebatch))[:, -1]
    got = fedsim.eval_logits(params, cfg, torch.from_numpy(
        ebatch["tokens"].astype(np.int64))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))

    hook = fedsim.EvalHook(1, eval_n=16)
    exp = types.SimpleNamespace(model_cfg=cfg, pipeline=pipe, params=params,
                                device=CPU,
                                result=types.SimpleNamespace(accuracies=[]))
    for t in (1, 2):
        hook.on_boundary(t, exp)
        jhook.on_boundary(t, jexp)
    assert exp.result.accuracies == jexp.result.accuracies
    assert len(exp.result.accuracies) == 2
    assert exp.result.accuracies[0] == tasks.accuracy(
        got[:, None, :], ebatch)


def test_cli_scan_engine_matches_loop_on_cpu():
    from repro_torch.launch import train
    args = ["--reduced", "--rounds", "4", "--device", "cpu", "--clients",
            "3", "--batch", "2", "--seq-len", "16", "--n-perturb", "1",
            "--eval-every", "2"]
    loop = train.main(args + ["--engine", "loop"])
    scan = train.main(args + ["--engine", "scan", "--chunk-rounds", "2"])
    assert scan["engine"] == "scan" and scan["rounds"] == 4
    assert scan["final_loss"] == loop["final_loss"]
    assert len(scan["accuracies"]) == len(loop["accuracies"]) == 2
    assert scan["accuracies"] == loop["accuracies"]
    assert scan["prep_stall_s"] >= 0.0
    assert train.build_parser().parse_args([]).eval_every == 100
