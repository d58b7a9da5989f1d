"""The port's transports (analog, sign, perfect, digital, smart_digital;
fo in `test_torch_fo.py`) against `repro`.

Tolerances:
- the aggregates (`analog_ota`, `sign_ota`, `perfect_analog`,
  `perfect_sign`, `effective_noise_std`) on the same payloads, control
  values and `repro`'s own normals: within 4 float32 ulps of the sum of
  the magnitudes of the terms they add (the sums may run in another
  order); sign outputs (±1, 0) exactly;
- payload bits, bits per round, `charges_privacy` and `uplink_bits_total`:
  equal;
- a tiny dense run over the wrapped rician channel on squad (horizon 32,
  8 rounds) under sign/solution, analog/static and perfect, against
  `repro`'s loop run with its OTA normals injected: losses rtol 1e-4
  (f32 differences compound through the updates, as in
  `test_torch_slice.py`), p̂ rtol 1e-4 with an atol of 2·8 f32 ulps of the
  loss over 2μ (a projection is a difference of two losses over 2μ, so
  their rounding is amplified 1/(2μ) = 500 times; the noise-free perfect
  mean shows it); privacy spent, uplink bits and each round's
  mask sum exactly; the port's scan run bitwise its loop run;
- the CLI with the new flags: equal JSON under `--engine loop` and
  `--engine scan`; its flags' defaults equal to `repro.launch.train`'s;
- `stochastic_quantize` with `repro`'s uniforms for the same key: bitwise;
  the digital aggregates within 4 ulps of the sum of |mask·q|;
- a 4-round digital and smart_digital run from the same seed (nothing
  injected) against `repro`'s: losses rtol 1e-4 and p̂ within 1e-5 up to
  the first round whose p̂ differs by a whole quantizer cell over
  K·n_perturb, if any (a projection within f32 rounding of a cell's
  threshold rounds into the neighbouring cell in one package; the runs
  then part, and only that round's loss is still compared).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.channel import realize_from_config as jrealize  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import fedsim as jfedsim  # noqa: E402
from repro.core import ota as jota  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.data.pipeline import FederatedPipeline as JPipe  # noqa: E402
from repro.data.tasks import TaskSpec as JSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import engine, fedsim, ota  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.data.pipeline import FederatedPipeline  # noqa: E402
from repro_torch.data.tasks import TaskSpec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_round import configs  # noqa: E402
from test_torch_slice import jax_trace_noise  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
WRAPPED = dict(model="rician", rician_k=3.0, cell_radius=100.0,
               phase_err_std=0.1, outage_db=-10.0)


def _normals(key, k: int) -> np.ndarray:
    """The K + 1 normals `repro.core.ota.superpose` draws from `key`."""
    nk_key, z_key = jax.random.split(key)
    return np.concatenate([
        np.asarray(jax.random.normal(nk_key, (k,), jnp.float32)),
        np.asarray(jax.random.normal(z_key, (), jnp.float32))[None]])


def _case(i: int):
    """Payloads and control for case i: payloads with exact zeros, c = 0,
    masks with zeros, CSI factors g != 1, artificial noise σ > 0."""
    rng = np.random.default_rng(100 + i)
    k = 5 + i % 3
    p = rng.normal(size=k).astype(np.float32) * 3
    p[rng.random(k) < 0.3] = 0.0
    c = [0.37, 0.0, 1.8, 0.05, 0.0, 2.5][i % 6]
    sigma = (rng.random(k) * (i % 2)).astype(np.float32)
    mask = (rng.random(k) < 0.7).astype(np.float32) if i % 3 else \
        np.ones(k, np.float32)
    g = np.cos(rng.normal(size=k) * 0.3).astype(np.float32) if i % 4 else \
        np.ones(k, np.float32)
    return dict(p=p, c=np.float32(c), sigma=sigma, n0=np.float32(1.0 + i),
                mask=mask, g=g, key=jax.random.key(i))


def _close(ours: torch.Tensor, ref, scale: float) -> None:
    ref = np.asarray(ref, dtype=np.float32)
    assert abs(float(ours) - float(ref)) <= 4 * EPS32 * max(scale, 1e-30), \
        (float(ours), float(ref), scale)


@pytest.mark.parametrize("i", range(12))
def test_aggregates_match_reference(i):
    cs = _case(i)
    k = cs["p"].shape[0]
    noise = _normals(cs["key"], k)
    t = {n: torch.from_numpy(np.asarray(cs[n])) for n in
         ("p", "c", "sigma", "n0", "mask", "g")}
    j = {n: jnp.asarray(cs[n]) for n in ("p", "c", "sigma", "n0", "mask",
                                          "g")}
    for fn, payload in (("analog_ota", cs["p"]),
                        ("sign_ota", np.sign(cs["p"]))):
        ours, k_eff = getattr(ota, fn)(t["p"], t["c"], t["sigma"], t["n0"],
                                       torch.from_numpy(noise), t["mask"],
                                       t["g"])
        ref, jk_eff = getattr(jota, fn)(j["p"], j["c"], j["sigma"], j["n0"],
                                        cs["key"], j["mask"], j["g"])
        assert float(k_eff) == float(jk_eff)
        w = cs["mask"] * cs["g"]
        terms = cs["c"] * np.sum(np.abs(w * (payload + cs["sigma"]
                                              * noise[:k]))) \
            + np.sqrt(cs["n0"]) * abs(noise[k])
        scale = terms / (float(k_eff) * cs["c"]) if cs["c"] > 0 else 0.0
        _close(ours, ref, scale)
        if cs["c"] == 0:
            assert float(ours) == 0.0 == float(ref)
    for mask in (None, t["mask"]):
        jmask = None if mask is None else j["mask"]
        _close(ota.perfect_analog(t["p"], mask),
               jota.perfect_analog(j["p"], jmask),
               float(np.sum(np.abs(cs["p"]))))
        ours = ota.perfect_sign(t["p"], mask)
        assert float(ours) == float(jota.perfect_sign(j["p"], jmask))
    _close(ota.effective_noise_std(t["c"], t["sigma"], t["n0"]),
           jota.effective_noise_std(j["c"], j["sigma"], j["n0"]),
           float(cs["c"] ** 2 * np.sum(cs["sigma"] ** 2) + cs["n0"]))


def test_sign_of_exact_zero_is_zero():
    p = torch.tensor([0.0, -0.0, 2.0, -3.0, 0.0])
    assert torch.equal(torch.sign(p), torch.tensor([0.0, 0.0, 1.0, -1.0,
                                                    0.0]))
    # a tied vote (one +1, one -1, three zeros) is 0, as jnp.sign gives
    assert float(ota.perfect_sign(p)) == 0.0 == float(
        jota.perfect_sign(jnp.asarray(p.numpy())))


def _pz(mod, mechanism, scheme, rounds=32, n_perturb=2, **chan):
    return mod.PairZeroConfig(
        variant="sign" if mechanism == "sign" else "analog", n_clients=5,
        rounds=rounds,
        zo=mod.ZOConfig(mu=1e-3, lr=5e-3, clip_gamma=5.0,
                        n_perturb=n_perturb),
        channel=mod.ChannelConfig(n0=1.0, power=100.0, **chan),
        dp=mod.DPConfig(epsilon=5.0, delta=0.01),
        power=mod.PowerControlConfig(scheme=scheme),
        transport=mod.TransportConfig(mechanism=mechanism, scheme=scheme),
        seed=0)


@pytest.mark.parametrize("mechanism,scheme", [
    ("analog", "solution"), ("analog", "static"), ("analog", "perfect"),
    ("sign", "solution"), ("sign", "reversed"), ("sign", "perfect"),
    ("perfect", "perfect")])
def test_bits_and_privacy_flags_match_reference(mechanism, scheme):
    pz, jpz = _pz(base, mechanism, scheme, n_perturb=4), \
        _pz(jbase, mechanism, scheme, n_perturb=4)
    mech, jmech = tp.resolve(pz), jtp.resolve(jpz)
    trace = jrealize(jpz.channel, 7, 32, 5)
    sched = jmech.make_schedule(trace, jpz)
    assert mech.charges_privacy(sched, pz) == \
        jmech.charges_privacy(sched, jpz)
    for d in (1, 125_239_296):
        assert mech.payload_bits(pz, d) == jmech.payload_bits(jpz, d)
        assert mech.bits_per_round(pz, d) == jmech.bits_per_round(jpz, d)
        for client_rounds, rounds in ((0.0, 0), (39.0, 8), (3997.0, 800)):
            assert tp.uplink_bits_total(mech, None, pz, d, client_rounds,
                                        rounds) == \
                jtp.uplink_bits_total(jmech, None, jpz, d, client_rounds,
                                      rounds)
    assert mech.payload_bits(pz, 1) == (1 if mechanism == "sign" else 16) * 4
    assert tp.OTA_SCHEMES == jtp.OTA_SCHEMES


class _Rows:
    """on_round callback keeping each round's mask sum."""

    def __init__(self):
        self.k_eff = []

    def __call__(self, t, metrics):
        self.k_eff.append(float(metrics["k_eff"]))


@pytest.mark.parametrize("mechanism,scheme", [
    ("sign", "solution"), ("analog", "static"), ("perfect", "perfect")])
def test_wrapped_rician_squad_run_matches_reference(monkeypatch, mechanism,
                                                    scheme):
    cfg, _ = configs(base)
    jcfg, _ = configs(jbase)
    pz, jpz = _pz(base, mechanism, scheme, **WRAPPED), \
        _pz(jbase, mechanism, scheme, **WRAPPED)
    spec = ("squad", 64, 24)
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    jrows, rows, scan_rows = _Rows(), _Rows(), _Rows()
    ref = jfedsim.run(jcfg, jpz, JPipe(spec[0], JSpec(*spec), 5, 4, seed=0),
                      rounds=8, engine="loop", params=jparams,
                      dtype=jnp.float32, on_round=jrows)
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    pipe = lambda: FederatedPipeline(spec[0], TaskSpec(*spec), 5, 4,  # noqa
                                     seed=0)
    res = fedsim.run(cfg, pz, pipe(), 8, params=params_from_numpy(host),
                     device="cpu", on_round=rows)
    assert res.steps == ref.steps == 8
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    # a projection is (L+ − L−)/(2μ): 8 f32 ulps of rounding in each loss
    # move it by 2·8·eps·|L|/(2μ) ≈ 4e-3, which no rtol on p̂ bounds where
    # p̂ is a noise-free mean (perfect)
    atol = 2 * 8 * EPS32 * max(map(abs, ref.losses)) / (2 * pz.zo.mu)
    np.testing.assert_allclose(res.p_hats, ref.p_hats, rtol=1e-4, atol=atol)
    np.testing.assert_array_equal(res.schedule.c, ref.schedule.c)
    np.testing.assert_array_equal(res.privacy_spent_per_round,
                                  ref.privacy_spent_per_round)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits
    assert rows.k_eff == jrows.k_eff and min(rows.k_eff) < 5
    bits = {"sign": 1, "analog": 16, "perfect": 16}[mechanism]
    assert res.uplink_bits == bits * 2 * sum(rows.k_eff)
    assert (res.privacy_spent > 0) == (mechanism != "perfect")
    scan = fedsim.run(cfg, pz, pipe(), 8, params=params_from_numpy(host),
                      device="cpu", engine="scan", chunk_rounds=4,
                      on_round=scan_rows)
    assert scan.losses == res.losses and scan.p_hats == res.p_hats
    assert scan.privacy_spent == res.privacy_spent
    assert scan.uplink_bits == res.uplink_bits
    assert scan_rows.k_eff == rows.k_eff
    from repro_torch.core import zo
    for (path, x), (_, y) in zip(zo.flatten(scan.params),
                                 zo.flatten(res.params)):
        assert torch.equal(x, y), path


def _wrapped_stack(ch):
    """The WRAPPED stack built by hand from a channel package's classes."""
    return ch.OutageModel(
        base=ch.ImperfectCSI(
            base=ch.PathLossGeometry(base=ch.RicianFading(k_factor=3.0),
                                     cell_radius=100.0),
            phase_err_std=0.1),
        threshold_db=-10.0)


def test_explicit_channel_model_overrides_config(monkeypatch):
    """`channel_model=` replaces the `pz.channel` stack: under a rayleigh
    config the hand-built wrapped stack gives `repro`'s run with the same
    model, and the same run as the config that asks for that stack."""
    import repro.channel as jch
    from repro_torch import channel as ch
    from repro_torch.models import registry
    cfg, _ = configs(base)
    jcfg, _ = configs(jbase)
    pz, jpz = _pz(base, "sign", "solution"), _pz(jbase, "sign", "solution")
    spec = ("squad", 64, 24)
    jparams = jreg.init_params(jax.random.key(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    jrows, rows, cfg_rows = _Rows(), _Rows(), _Rows()
    ref = jfedsim.run(jcfg, jpz, JPipe(spec[0], JSpec(*spec), 5, 4, seed=0),
                      rounds=4, engine="loop", params=jparams,
                      dtype=jnp.float32, on_round=jrows,
                      channel_model=_wrapped_stack(jch))
    monkeypatch.setattr(engine, "noise_rows", jax_trace_noise)
    pipe = lambda: FederatedPipeline(spec[0], TaskSpec(*spec), 5, 4,  # noqa
                                     seed=0)
    res = fedsim.run(cfg, pz, pipe(), 4, params=params_from_numpy(host),
                     device="cpu", on_round=rows,
                     channel_model=_wrapped_stack(ch))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    np.testing.assert_array_equal(res.schedule.c, ref.schedule.c)
    assert res.privacy_spent == ref.privacy_spent
    assert res.uplink_bits == ref.uplink_bits
    assert rows.k_eff == jrows.k_eff and min(rows.k_eff) < 5
    from_cfg = fedsim.run(cfg, _pz(base, "sign", "solution", **WRAPPED),
                          pipe(), 4, params=params_from_numpy(host),
                          device="cpu", on_round=cfg_rows)
    assert from_cfg.losses == res.losses and from_cfg.p_hats == res.p_hats
    np.testing.assert_array_equal(from_cfg.schedule.c, res.schedule.c)
    assert from_cfg.privacy_spent == res.privacy_spent
    assert cfg_rows.k_eff == rows.k_eff
    # the rayleigh config alone has no outage: every client transmits
    alone_rows = _Rows()
    plain = registry.init_params(cfg, prng.key(3),
                                 torch.device("cpu"))
    fedsim.run(cfg, pz, pipe(), 4, params=plain, device="cpu",
               on_round=alone_rows)
    assert alone_rows.k_eff == [5.0] * 4


def test_silent_rounds_update_nothing_and_spend_nothing():
    """Sign at horizon 800: the first rounds are silent (c = 0), so p̂ = 0
    and no privacy is spent, on both engines."""
    cfg, _ = configs(base)
    pz = _pz(base, "sign", "solution", rounds=800, **WRAPPED)
    pipe = lambda: FederatedPipeline("squad", TaskSpec("squad", 64, 24), 5,  # noqa
                                     4, seed=0)
    from repro_torch.models import registry
    out = []
    for kw in (dict(), dict(engine="scan", chunk_rounds=2)):
        params = registry.init_params(cfg, prng.key(3),
                                      torch.device("cpu"))
        out.append(fedsim.run(cfg, pz, pipe(), 3, params=params,
                              device="cpu", **kw))
    for res in out:
        assert res.p_hats == [0.0, 0.0, 0.0]
        assert res.privacy_spent == 0.0 and res.steps == 3
        assert (res.schedule.c[:3] == 0.0).all()
    assert out[0].losses == out[1].losses


def test_cli_new_flags_loop_equals_scan_on_cpu():
    from repro_torch.launch import train
    args = ["--reduced", "--rounds", "4", "--device", "cpu", "--clients",
            "5", "--batch", "2", "--seq-len", "16", "--n-perturb", "1",
            "--eval-every", "2", "--transport", "sign", "--channel",
            "rician", "--rician-k", "4", "--outage-db", "-10",
            "--cell-radius", "150", "--csi-phase-err", "0.1",
            "--shadow-std-db", "2", "--task", "squad"]
    loop = train.main(args + ["--engine", "loop"])
    scan = train.main(args + ["--engine", "scan", "--chunk-rounds", "2"])
    # compile_stats name the engine's own executor build
    drop = ("engine", "wall_time_s", "prep_stall_s", "compile_stats")
    assert {k: v for k, v in loop.items() if k not in drop} == \
        {k: v for k, v in scan.items() if k not in drop}
    assert scan["compile_stats"]["loop_executor_build"] == 0
    assert (loop["transport"], loop["scheme"], loop["channel"]) == \
        ("sign", "solution", "rician")
    assert loop["uplink_bits"] < 4 * 5 and loop["privacy_spent"] > 0
    # --variant is the deprecated alias of --transport
    alias = train.main(args[:15] + ["--variant", "sign", "--task", "lm",
                                    "--channel", "ar1", "--doppler-hz",
                                    "30", "--scheme", "static"])
    assert alias["transport"] == "sign" and alias["scheme"] == "static"


def test_cli_defaults_match_reference():
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    ours = {a.dest: a.default for a in train.build_parser()._actions}
    ref = {a.dest: a.default for a in jtrain.build_parser()._actions}
    for dest in ("task", "transport", "variant", "scheme", "channel",
                 "rician_k", "ar1_rho", "doppler_hz", "round_s",
                 "csi_phase_err", "outage_db", "cell_radius",
                 "shadow_std_db", "shadow_corr", "checkpoint_dir",
                 "checkpoint_every", "dropout_p", "straggler_p", "elastic",
                 "inject", "inject_seed"):
        assert ours[dest] == ref[dest], dest
    assert set(ours) - {"device", "help"} <= set(ref)


@pytest.mark.parametrize("mechanism,item", [
    ("digital", "A9"), ("smart_digital", "A9"), ("fo", "A9")])
def test_unported_transports_raise_naming_their_item(mechanism, item):
    """Every mechanism runs, and what each lacked until ROADMAP `item`
    (A9) was ported, a defense's bill in `uplink_bits_total`, is the
    reference's: the payload times the client-rounds, then a sub-slot
    defense's factor (1) and its side-channel bits a round; an unknown
    name is a ValueError."""
    from repro.byzantine import defenses as jdef
    from repro_torch.byzantine import defenses
    cfg, pz = configs(base, n_perturb=1)
    pz = dataclasses.replace(pz, transport=base.TransportConfig(
        mechanism=mechanism))
    mech = tp.resolve(pz)
    assert mech.name == mechanism and mechanism in tp.available()
    jmech = jtp.get(mechanism).from_config(jbase.TransportConfig(
        mechanism=mechanism), configs(jbase, n_perturb=1)[1])
    for ours, ref in ((defenses.ResidualReweight(groups=3),
                       jdef.ResidualReweight(groups=3)),
                      (defenses.RobustDecode(), jdef.RobustDecode())):
        bits = tp.uplink_bits_total(mech, ours, pz, 10, 5.0, 2)
        assert bits == jtp.uplink_bits_total(jmech, ref, pz, 10, 5.0, 2)
        assert bits == mech.payload_bits(pz, 10) * 5 + \
            ours.extra_bits_per_round(pz, 10) * 2
    assert item == "A9"
    with pytest.raises(ValueError):
        tp.get("carrier_pigeon")


@pytest.mark.parametrize("option,item", [("mesh", "A11"),
                                         ("telemetry", "A9")])
def test_unported_options_raise_naming_their_item(option, item):
    """`mesh` raises naming its ROADMAP item; `telemetry`, which A9
    ported, is no longer refused: an `obs.Telemetry` runs and records."""
    from repro_torch import obs
    cfg, pz = configs(base, n_perturb=1)
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", 64, 16), 5, 2)
    if item != "A9":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            fedsim.run(cfg, pz, pipe, rounds=1, device="cpu",
                       **{option: object()})
        return
    assert option not in fedsim._UNPORTED
    tel = obs.Telemetry.on()
    res = fedsim.run(cfg, pz, pipe, rounds=1, device="cpu",
                     **{option: tel})
    assert res.steps == 1 and res.peak_bytes > 0
    assert tel.tracer.spans("dispatch")


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("clip", [1.0, 5.0])
def test_stochastic_quantize_matches_reference_bitwise(bits, clip):
    rng = np.random.default_rng(bits * 10 + int(clip))
    levels = 2 ** bits - 1
    p = (rng.normal(size=64) * clip).astype(np.float32)
    # cell edges, the clip bounds and beyond, exact zeros
    p[:8] = (np.arange(8) * 2 * clip / levels - clip).astype(np.float32)
    p[8:12] = np.float32([clip, -clip, 3 * clip, -3 * clip])
    p[12] = 0.0
    key = jax.random.key(bits + 17)
    u = jax.random.uniform(key, p.shape, jnp.float32)
    ref = np.asarray(jtp.stochastic_quantize(jnp.asarray(p), key, bits=bits,
                                             clip=clip))
    ours = tp.stochastic_quantize(
        torch.from_numpy(p), prng.uniform(prng.wrap_key_data(
            jax.random.key_data(key)), p.shape), bits=bits, clip=clip)
    np.testing.assert_array_equal(np.asarray(u), prng.uniform(
        prng.wrap_key_data(jax.random.key_data(key)), p.shape).numpy())
    np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("mechanism", ["digital", "smart_digital"])
def test_digital_transports_match_reference(mechanism):
    pz, jpz = _pz(base, mechanism, "solution", n_perturb=4), \
        _pz(jbase, mechanism, "solution", n_perturb=4)
    pz = dataclasses.replace(pz, transport=dataclasses.replace(
        pz.transport, quant_bits=6))
    jpz = dataclasses.replace(jpz, transport=dataclasses.replace(
        jpz.transport, quant_bits=6))
    mech, jmech = tp.resolve(pz), jtp.resolve(jpz)
    assert (mech.quant_bits, mech.clip) == (jmech.quant_bits, jmech.clip) \
        == (6, 5.0)
    assert mech.draws == ("uniform",) and not mech.charges_privacy(None, pz)
    trace = jrealize(jpz.channel, 7, 32, 5)
    sched, jsched = mech.make_schedule(trace, pz), \
        jmech.make_schedule(trace, jpz)
    assert sched.scheme == jsched.scheme == "digital"
    np.testing.assert_array_equal(sched.c, jsched.c)
    assert mech.charges_privacy(sched, pz) == \
        jmech.charges_privacy(jsched, jpz) is False
    for d in (1, 125_239_296):
        assert mech.payload_bits(pz, d) == jmech.payload_bits(jpz, d)
        assert mech.bits_per_round(pz, d) == jmech.bits_per_round(jpz, d)
        for client_rounds, rounds in ((0.0, 0), (39.0, 8), (3997.0, 800)):
            assert tp.uplink_bits_total(mech, None, pz, d, client_rounds,
                                        rounds) == \
                jtp.uplink_bits_total(jmech, None, jpz, d, client_rounds,
                                      rounds)
    assert mech.payload_bits(pz, 1000) == (
        6 * 1000 if mechanism == "digital" else 6 * 4)
    for i in range(6):
        cs = _case(i)
        key = jax.random.fold_in(cs["key"], 3)
        u = prng.uniform(prng.wrap_key_data(jax.random.key_data(key)),
                         cs["p"].shape)
        ours = mech.aggregate(torch.from_numpy(cs["p"]), {
            "mask": torch.from_numpy(cs["mask"]), "uniform": u,
            "g": torch.from_numpy(cs["g"])})
        ref = jmech.aggregate(jnp.asarray(cs["p"]), {
            "mask": jnp.asarray(cs["mask"]), "g": jnp.asarray(cs["g"])}, key)
        _close(ours, ref, 5.0 * float(np.sum(cs["mask"])) / max(
            float(np.sum(cs["mask"])), 1.0))
    assert tp.from_strings("digital", "solution", pz) == tp.DigitalTDMA(
        clip=5.0)
    with pytest.raises(ValueError, match="digital"):
        tp.from_strings("digital", "solution")


def parted_at_flip(pz, ours, ref):
    """The round at which two digital runs part at a whole-cell flip (None
    if they never do); raises on any other difference."""
    mech = tp.resolve(pz)
    cell = 2 * mech.clip / (2 ** mech.quant_bits - 1) / (
        pz.n_clients * pz.zo.n_perturb)
    for r, (a, b, pa, pb) in enumerate(zip(ours.losses, ref.losses,
                                           ours.p_hats, ref.p_hats)):
        np.testing.assert_allclose(a, b, rtol=1e-4)
        if abs(pa - pb) <= 1e-5:
            continue
        cells = round((pa - pb) / cell)
        assert cells != 0 and abs(pa - pb - cells * cell) <= 1e-5, \
            (r, pa, pb, cell)
        return r
    return None


@pytest.mark.parametrize("mechanism", ["digital", "smart_digital"])
def test_digital_runs_match_reference(mechanism):
    """Same seed, nothing injected: the dither is the reference's own
    draws. The losses agree up to the first whole-cell flip, if any (at
    these settings round 1's second direction has a payload 0.006 of a
    cell from its threshold, and the two packages round it apart)."""
    cfg, _ = configs(base)
    jcfg, _ = configs(jbase)
    pz, jpz = _pz(base, mechanism, "solution", rounds=8), \
        _pz(jbase, mechanism, "solution", rounds=8)
    spec = ("sst2", 64, 24)
    ref = jfedsim.run(jcfg, jpz, JPipe(spec[0], JSpec(*spec), 5, 4, seed=0),
                      rounds=4, engine="loop", dtype=jnp.float32)
    pipe = lambda: FederatedPipeline(spec[0], TaskSpec(*spec), 5, 4,  # noqa
                                     seed=0)
    res = fedsim.run(cfg, pz, pipe(), 4, device="cpu")
    assert res.steps == ref.steps == 4
    parted = parted_at_flip(pz, res, ref)
    assert parted is None or parted >= 1        # round 0 starts equal
    assert res.privacy_spent == ref.privacy_spent == 0.0
    assert res.uplink_bits == ref.uplink_bits == \
        tp.resolve(pz).payload_bits(pz, cfg.param_count()) * 20
    scan = fedsim.run(cfg, pz, pipe(), 4, device="cpu", engine="scan",
                      chunk_rounds=3)
    assert scan.losses == res.losses and scan.p_hats == res.p_hats
    from repro_torch.core import zo
    for (path, x), (_, y) in zip(zo.flatten(scan.params),
                                 zo.flatten(res.params)):
        assert torch.equal(x, y), path
