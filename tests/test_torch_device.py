"""The port's device-model backends against the JAX package's.

The measured backend's dataset is a byte-identical copy of the reference's;
`from_file` reads the same tuples and raises the same errors; its HRS leak
is the same float64 interpolation.  Variation masks are drawn under the
same keys on both sides, the reference jitted as its sweeps draw them, and
must agree bit for bit: the measured mask (the die-sampling kernel's
measured tail on the card, its plain version here) at batched keys under
both threefry schemes, the retention drift at 0 (the identity), 30 and 365
days over both bases.  The registry's names and errors, the periphery
guard of the kernel route, and the detector sweep on an aged, measured
device (per-chip mAPs equal to the reference's at the same chip ids) close
the file.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import device as jdev  # noqa: E402
from repro.core import nonideal as jni  # noqa: E402
from repro.core.macro import DEFAULT_MACRO as JMACRO  # noqa: E402
from repro_torch import device as tdev  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core.crossbar import sample_chip_planes  # noqa: E402
from repro_torch.core.macro import DEFAULT_MACRO as TMACRO  # noqa: E402

torch.set_num_threads(2)

SHAPE = (70, 24)


def _differ(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    return int(np.sum(got.view(np.uint32) != want.view(np.uint32)))


def _keys(flag: bool):
    """Keys [4, 2] in both packages: fold_in(PRNGKey(3), c) over c."""
    ids = np.arange(4)
    with jax.threefry_partitionable(flag):
        jk = jax.vmap(lambda c: jax.random.fold_in(jax.random.PRNGKey(3),
                                                   c))(jnp.asarray(ids))
    tk = prng.fold_in(prng.PRNGKey(3, device="cpu"), torch.from_numpy(ids))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    return jk, tk


def _jmask(model, keys, shape, flag):
    """The reference's mask at each key, jitted as its sweeps draw it."""
    with jax.threefry_partitionable(flag):
        return np.asarray(jax.jit(jax.vmap(
            lambda k: model.variation_mask(k, shape, JMACRO)))(keys))


def test_dataset_is_a_byte_identical_copy():
    from repro.device.measured import SAMPLE_DATASET as JDATA
    from repro_torch.device.measured import SAMPLE_DATASET as TDATA
    assert TDATA != JDATA and TDATA.is_file()
    assert TDATA.read_bytes() == JDATA.read_bytes()


def test_from_file_reads_the_reference_tuples():
    j = jdev.MeasuredDeviceModel.from_file()
    t = tdev.MeasuredDeviceModel.from_file()
    for f in ("dataset", "var_q", "var_factor", "iv_v", "iv_lrs_ua",
              "iv_hrs_ua"):
        assert getattr(t, f) == getattr(j, f), f
    assert hash(t) == hash(tdev.MeasuredDeviceModel.from_file())
    assert t.name == j.name == "measured"
    for v in (0.05, 0.2, 0.25, 0.3):
        spec = TMACRO.__class__(v_read=v)
        assert t.hrs_leak_units(spec) == j.hrs_leak_units(
            JMACRO.__class__(v_read=v))


@pytest.mark.parametrize("bad", ["short", "misaligned", "unsorted"])
def test_from_file_raises_the_reference_errors(tmp_path, bad):
    d = json.loads(tdev.SAMPLE_DATASET.read_text())
    q, f = d["variation"]["quantile"], d["variation"]["factor"]
    if bad == "short":
        d["variation"] = {"quantile": q[:1], "factor": f[:1]}
    elif bad == "misaligned":
        d["variation"]["factor"] = f[:-1]
    else:
        d["variation"]["quantile"] = q[:3] + [q[2]] + q[4:]
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(d))
    with pytest.raises(ValueError) as je:
        jdev.MeasuredDeviceModel.from_file(p)
    with pytest.raises(ValueError) as te:
        tdev.MeasuredDeviceModel.from_file(p)
    assert str(te.value) == str(je.value)


def test_variation_factor_is_jnp_interp():
    j = jdev.MeasuredDeviceModel.from_file()
    t = tdev.MeasuredDeviceModel.from_file()
    q = np.float32(j.var_q)
    u = np.concatenate([np.random.default_rng(1).random(20_000), q,
                        np.nextafter(q, 0), np.nextafter(q, 1),
                        [0.0, 1.0]]).astype(np.float32)
    assert _differ(t.variation_factor(torch.from_numpy(u)),
                   jax.jit(j.variation_factor)(u)) == 0


@pytest.mark.parametrize("flag", [True, False],
                         ids=["partitionable", "original"])
def test_measured_mask_at_batched_keys(flag):
    jk, tk = _keys(flag)
    j = jdev.MeasuredDeviceModel.from_file()
    t = tdev.MeasuredDeviceModel.from_file()
    want = _jmask(j, jk, SHAPE, flag)
    with prng.threefry_partitionable(flag):
        got = t.variation_mask(tk, SHAPE, TMACRO)
        keys2 = tk.reshape(2, 2, 2)
        got2 = t.variation_mask(keys2, SHAPE, TMACRO)
    assert got.shape == (4,) + SHAPE
    assert _differ(got, want) == 0
    assert _differ(got2.reshape(got.shape), want) == 0


@pytest.mark.parametrize("name", ["analytic", "measured"])
@pytest.mark.parametrize("scheme", ["ternary", "binary"])
def test_sample_chip_planes_match_for_both_schemes(name, scheme):
    """Planes of a [4, 2] key batch: `binary`'s reference line takes one
    mask [rows, 1] common to every column."""
    from repro.core.crossbar import sample_chip_planes as jsample
    rng = np.random.default_rng(2)
    gp = (rng.random(SHAPE) < 0.3).astype(np.float32)
    gn = (rng.random(SHAPE) < 0.3).astype(np.float32)
    if scheme == "binary":
        gn = np.full(SHAPE, 0.5, np.float32)
    jk, tk = _keys(True)
    jd, td = (jdev.get_device_model(name, 30.0),
              tdev.get_device_model(name, 30.0))
    with jax.threefry_partitionable(True):
        jep, jen, _ = jax.jit(jax.vmap(lambda k: jsample(
            k, gp, gn, scheme, jni.NonidealConfig.all(), JMACRO, jd)))(jk)
    with prng.threefry_partitionable(True):
        tep, ten, _ = sample_chip_planes(
            tk, torch.from_numpy(gp), torch.from_numpy(gn), scheme,
            tni.NonidealConfig.all(), TMACRO, td)
        if scheme == "binary":
            ks = prng.split(tk, 3)
            en_mask = td.variation_mask(ks[..., 1, :], (SHAPE[0], 1), TMACRO)
            assert en_mask.shape == (4, SHAPE[0], 1)
    assert _differ(tep, jep) == 0 and _differ(ten, jen) == 0


@pytest.mark.parametrize("name", ["analytic", "measured"])
@pytest.mark.parametrize("t_days", [30.0, 365.0])
def test_retention_drift_matches(name, t_days):
    jk, tk = _keys(True)
    j = jdev.get_device_model(name, t_days)
    t = tdev.get_device_model(name, t_days)
    assert isinstance(t, tdev.RetentionDrift) and t.name == j.name
    assert t._decay() == j._decay() and t._spread_sigma() == j._spread_sigma()
    with prng.threefry_partitionable(True):
        got = t.variation_mask(tk, SHAPE, TMACRO)
        base = t.base.variation_mask(tk, SHAPE, TMACRO)
    assert _differ(got, _jmask(j, jk, SHAPE, True)) == 0
    assert not torch.equal(got, base)


def test_retention_at_day_zero_is_the_identity(monkeypatch):
    """t_days = 0 returns the base mask itself: no drift draw, no op."""
    _, tk = _keys(True)
    for base in (tdev.ANALYTIC_DEVICE, tdev.MeasuredDeviceModel.from_file()):
        aged = tdev.RetentionDrift(base=base, t_days=0.0)
        want = base.variation_mask(tk, SHAPE, TMACRO)
        calls = []
        real = prng.fold_in
        monkeypatch.setattr(prng, "fold_in",
                            lambda *a: calls.append(a) or real(*a))
        got = aged.variation_mask(tk, SHAPE, TMACRO)
        monkeypatch.setattr(prng, "fold_in", real)
        assert calls == [] and torch.equal(got, want)
    assert tdev.get_device_model("measured", 0) == \
        tdev.MeasuredDeviceModel.from_file()


def test_registry_names_and_errors():
    assert tdev.DEVICE_MODELS == jdev.DEVICE_MODELS
    for name in tdev.DEVICE_MODELS:
        for t in (0, 30, 365, 0.5):
            assert (tdev.get_device_model(name, t).name
                    == jdev.get_device_model(name, t).name)
    assert tdev.get_device_model("measured", 30).name == "measured@t30d"
    assert tdev.get_device_model("analytic") is tdev.ANALYTIC_DEVICE
    assert tdev.default_device(None) is tdev.ANALYTIC_DEVICE
    m = tdev.get_device_model("measured")
    assert tdev.default_device(m) is m
    with pytest.raises(ValueError) as je:
        jdev.get_device_model("spice")
    with pytest.raises(ValueError) as te:
        tdev.get_device_model("spice")
    assert str(te.value) == str(je.value)
    aged = tdev.get_device_model("measured", 30)
    assert aged.analytic_periphery and aged.hrs_leak_units(TMACRO) == \
        m.hrs_leak_units(TMACRO)
    p = torch.arange(0.0, 300.0)
    assert torch.equal(aged.sa_offset_sigma(p, TMACRO, 1.0),
                       tdev.ANALYTIC_DEVICE.sa_offset_sigma(p, TMACRO, 1.0))


def test_kernel_route_refuses_a_non_analytic_periphery():
    from repro_torch.mc.engine import ensemble_apply_kernel
    from repro_torch.mc.ensemble import sample_ensemble
    from repro_torch.core.mapping import ternary_planes

    class OwnPeriphery(tdev.MeasuredDeviceModel):
        @property
        def analytic_periphery(self):
            return False

    base = tdev.MeasuredDeviceModel.from_file()
    own = OwnPeriphery(**{f: getattr(base, f) for f in (
        "dataset", "var_q", "var_factor", "iv_v", "iv_lrs_ua", "iv_hrs_ua")})
    aged = tdev.RetentionDrift(base=own, t_days=30.0)
    assert not aged.analytic_periphery
    w = torch.from_numpy(np.sign(np.random.default_rng(3).standard_normal(
        (40, 8))).astype(np.float32))
    ens = sample_ensemble(prng.PRNGKey(0, device="cpu"), ternary_planes(w), 2,
                          cfg=tni.NonidealConfig.all(), device=aged)
    with pytest.raises(NotImplementedError, match="non-analytic"):
        ensemble_apply_kernel(ens, torch.zeros((4, 40)),
                              cfg=tni.NonidealConfig.all(), device=aged)


@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke-geometry detector (init PRNGKey(0), stem BN
    calibrated on 8 synthetic images), the same params in the port, and a
    2-image eval batch."""
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    from repro_torch.configs import yolo_irc as tcfg
    from repro_torch.convert import params_from_jax
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.models.detector import IRCDetector
    jdet = JDet(jcfg.smoke("ternary"))
    det = IRCDetector(tcfg.smoke())
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    jp = jdet.calibrate_bn(jdet.init(jax.random.PRNGKey(0)), jnp.asarray(
        data.batch_for_step(999, 8).images))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return jdet, jp, det, tp, data.batch_for_step(1000, 2)


@pytest.mark.parametrize("t_days", [0.0, 365.0])
def test_detector_dies_and_heads_on_a_measured_device(smoke, t_days):
    """Every group's dies bit for bit (the jitted reference's
    `build_detector_ensemble`) and one chunk's head at the detector-MC bar
    (>= 99% of elements within 1e-4), on the measured device at 0 and 365
    days."""
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import (_sampled_chunk_forward,
                                      build_detector_ensemble as jbuild,
                                      detector_planes as jplanes)
    from repro_torch.mc import detector_mc as tmc
    jdet, jp, det, tp, ev = smoke
    jd = jdev.get_device_model("measured", t_days)
    td = tdev.get_device_model("measured", t_days)
    ids = jnp.asarray([1, 6], dtype=jnp.uint32)
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        jens = jax.jit(lambda k, p: jbuild(k, jdet, p, chip_ids=ids,
                                           cfg=JNI.all(), device=jd))(
            jax.random.PRNGKey(9), jp)
        tens = tmc.build_detector_ensemble(
            prng.PRNGKey(9, device="cpu"), det, tp,
            chip_ids=torch.tensor([1, 6]), cfg=tni.NonidealConfig.all(),
            device=td)
        planes, meta = jplanes(jdet, jp)
        ref = np.asarray(_sampled_chunk_forward(
            jp, jnp.asarray(ev.images), jax.random.PRNGKey(5),
            jnp.arange(2, dtype=jnp.uint32), planes, det_cfg=jdet.cfg,
            spec=jdet.spec, cfg_ni=JNI.all(), sa_extra=0.0, meta=meta,
            use_kernel=True, kernel_impl="ref", device=jd))
        tpl, tmeta = tmc.detector_planes(det, tp)
        out = tmc._sample_and_forward(
            tp, torch.from_numpy(ev.images), prng.PRNGKey(5, device="cpu"),
            torch.arange(2), tpl, det_cfg=det.cfg, spec=det.spec,
            cfg_ni=tni.NonidealConfig.all(), sa_extra=0.0, meta=tmeta,
            device=td).numpy()
    for name, groups in jens.layers.items():
        for jg, tg in zip(groups, tens.layers[name]):
            assert _differ(tg.ep.numpy(), np.asarray(jg.ep)) == 0, name
            assert _differ(tg.en.numpy(), np.asarray(jg.en)) == 0, name
    close = float(np.mean(np.abs(out - ref) <= 1e-4))
    print(f"t={t_days:g}: {close:.4%} of head elements within 1e-4")
    assert out.shape == ref.shape and close >= 0.99


def test_detector_sweep_on_an_aged_measured_device(smoke):
    """`run_mc_detector` at the smoke geometry with measured@t365d: per-chip
    mAPs equal to the JAX package's at the same chip ids."""
    from repro.mc import McConfig as JMc, run_mc_detector as jrun
    from repro_torch.mc.detector_mc import run_mc_detector
    from repro_torch.mc.engine import McConfig
    jdet, jp, det, tp, ev = smoke
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        jres = jrun(jax.random.PRNGKey(4), jdet, jp, jnp.asarray(ev.images),
                    ev.boxes, ev.classes,
                    mc=JMc(n_chips=4, chunk_size=2,
                           device=jdev.get_device_model("measured", 365)),
                    use_kernel=True, kernel_impl="ref")
        tres = run_mc_detector(
            prng.PRNGKey(4, device="cpu"), det, tp,
            torch.from_numpy(ev.images), ev.boxes, ev.classes,
            mc=McConfig(n_chips=4, chunk_size=2,
                        device=tdev.get_device_model("measured", 365)))
    print("per-chip mAP", tres.per_chip["map50"].tolist())
    assert tres.n_chips == 4
    np.testing.assert_array_equal(tres.per_chip["map50"],
                                  np.asarray(jres.per_chip["map50"]))


def test_layer_cli_aging_sweep_matches_the_jax_cli(tmp_path, monkeypatch,
                                                   capsys):
    """Both CLIs with `--device-model measured --t-days 0,30`: the same run
    files, event kinds in the same order with the same fields (the port
    adds `enqueue_s` to `mc_result`), the same manifest summary, the same
    CSV header, labels, device model and ages, and per-chip values equal up
    to near-tie decisions."""
    import sys
    from repro.launch import mc as jcli
    from repro_torch.kernels.ref import NEAR_TIE_TOL
    from repro_torch.launch import mc as tcli
    from repro_torch.mc.ensemble import sample_ensemble
    from test_torch_layer_mc import _sa_margin
    small = ["--chips", "4", "--chunk", "2", "--batch", "8", "--fan-in",
             "32", "--n-out", "8", "--bias-rows", "4", "--ablation", "all",
             "--device-model", "measured", "--t-days", "0,30"]
    monkeypatch.setattr(sys, "argv", ["mc"] + small + [
        "--run-dir", str(tmp_path), "--run-id", "jax"])
    with jax.threefry_partitionable(True), prng.threefry_partitionable(True):
        jcli.main()
        tcli.main(small + ["--device", "cpu", "--run-dir", str(tmp_path),
                           "--run-id", "port"])
        args = type("A", (), dict(seed=0, fan_in=32, n_out=8,
                                  scheme="ternary", bias_rows=4, batch=8,
                                  density=0.5))
        mapped, x, _ = tcli.build_layer(args, "cpu")
        margins = {}
        for t in (0.0, 30.0):
            dev = tdev.get_device_model("measured", t)
            for name, cfg in (("ideal", tni.NonidealConfig.none()),
                              ("all", tni.NonidealConfig.all())):
                margins[f"{name}@t{t:g}d"] = _sa_margin(sample_ensemble(
                    prng.PRNGKey(0, device="cpu"), mapped, 4, cfg=cfg,
                    device=dev), x, cfg, "single_shot", 256)
    out = capsys.readouterr().out
    assert "device_model=measured t_days=0,30" in out
    jrun, trun = tmp_path / "jax", tmp_path / "port"
    files = {p.name for p in jrun.iterdir()}
    assert {p.name for p in trun.iterdir()} == files
    assert "per_chip_bit_agreement_all@t30d.npy" in files

    def events(run):
        return [json.loads(line) for line in
                (run / "metrics.jsonl").read_text().splitlines()]
    jev, tev = events(jrun), events(trun)
    assert [e["kind"] for e in tev] == [e["kind"] for e in jev]
    for j, t in zip(jev, tev):
        extra = {"enqueue_s"} if t["kind"] == "mc_result" else set()
        assert set(t) == set(j) | extra, t["kind"]
        if t["kind"] == "ablation_column":
            assert (t["device_model"], t["t_days"]) == (
                j["device_model"], j["t_days"])
    jman = json.loads((jrun / "manifest.json").read_text())
    tman = json.loads((trun / "manifest.json").read_text())
    assert tman["summary"] == jman["summary"] == {
        "network": "layer", "device_model": "measured", "t_days": [0.0, 30.0]}
    jcsv = [r.split(",") for r in (jrun / "results.csv").read_text()
            .splitlines()]
    tcsv = [r.split(",") for r in (trun / "results.csv").read_text()
            .splitlines()]
    assert tcsv[0] == jcsv[0]
    assert [(r[0], r[-2], r[-1]) for r in tcsv] == [(r[0], r[-2], r[-1])
                                                    for r in jcsv]
    jrep = json.loads((jrun / "report.json").read_text())["results"]
    trep = json.loads((trun / "report.json").read_text())["results"]
    assert set(trep) == set(jrep) == set(margins)
    for label, margin in margins.items():
        assert (trep[label]["device_model"], trep[label]["t_days"]) == (
            jrep[label]["device_model"], jrep[label]["t_days"])
        ties = (margin < NEAR_TIE_TOL).sum(dim=(-2, -1)).numpy()
        for metric in ("bit_agreement", "ones_fraction"):
            f = f"per_chip_{metric}_{label}.npy"
            gap = np.abs(np.load(trun / f) - np.load(jrun / f)) * 8 * 8
            print(f"{label} {metric}: outputs apart per chip "
                  f"{np.round(gap).tolist()}, near-ties {ties.tolist()}")
            assert np.all(np.round(gap) <= ties), f


def test_measured_tail_bound_is_per_pipe():
    """`chip_smoke.threefry_bound_ms` for the measured draw: the
    partitionable block and the measured tail's fewest instructions, issue
    bound at the 512-die layer mask."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_smoke_loader import chip_smoke
    smoke = chip_smoke()
    work = smoke.threefry_work("measured", True)
    assert work == {"alu": 59, "adds": 27, "fma": 62, "mufu": 3}
    n = 572 * 60
    got, by, pipe = smoke.threefry_bound_ms("measured", 512, n, True)
    assert (by, pipe) == ("operations", "issue")
    assert got == pytest.approx(151 / 128 * 512 * n / smoke.SM_CLOCKS_PER_S
                                * 1e3)
    assert "devices" in smoke.PHASES
