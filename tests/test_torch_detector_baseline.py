"""The baseline detector design (binary weights against a shared reference
line, in-memory BN folded into bias cells, partial sums of 212 rows) in the
port, against the JAX package on the smoke geometry `smoke("binary")`, with
the reference's initialized and calibrated params carried over.

The port is held to: `fold_bn_to_bias_units` and every group's BN units
and planes exactly; `calibrate_bn`'s stem and block statistics within
float32 reduction order (rtol 1e-5); the head of one chunk (4 chips x 2
images, all effects) within 1e-4 on >= 99% of elements against the
reference's plain ensemble route (partial sums reach no kernel there
either); and the per-chip mAP@0.5 of `run_ablation_detector` at the same
chip ids within 0.02 in every Table II column, the near-tie rule of the
proposed design's tests (`tests/test_torch_detector_mc.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.mapping import fold_bn_to_bias_units  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.mc import detector_mc as tmc  # noqa: E402
from repro_torch.mc.engine import McConfig  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this module's
    tests, the earlier settings restored after them: the same key gives
    the same dies on both sides, and the suite runs once, not once per
    scheme (`tests/test_torch_prng.py` and `test_torch_layer_mc.py` hold
    both schemes)."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def setup():
    """The reference's baseline smoke detector, initialized and calibrated
    (stem and block BN), its params in the port, the calibration images and
    a synthetic eval batch."""
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    jdet = JDet(jcfg.smoke("binary"))
    det = IRCDetector(tcfg.smoke("binary"))
    raw = jdet.init(jax.random.PRNGKey(0))
    calib = jax.random.uniform(jax.random.PRNGKey(1), (4, 32, 32, 3))
    jp = jdet.calibrate_bn(raw, calib)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    ev = data.batch_for_step(1000, 2)
    return jdet, raw, calib, jp, det, tp, ev


def test_configs_match_reference():
    from repro.configs import yolo_irc as jcfg
    for name in ("proposed", "baseline"):
        j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
        for field in ("img_hw", "stage_channels", "blocks_per_stage",
                      "scheme", "use_bn", "accumulation", "bias_rows",
                      "partial_rows", "group"):
            assert getattr(j, field) == getattr(t, field), (name, field)
    for scheme in ("ternary", "binary"):
        j, t = jcfg.smoke(scheme), tcfg.smoke(scheme)
        assert (j.scheme, j.use_bn, j.accumulation, j.bias_rows,
                j.partial_rows) == (t.scheme, t.use_bn, t.accumulation,
                                    t.bias_rows, t.partial_rows)
    with pytest.raises(ValueError, match="scheme"):
        tcfg.smoke("analog")


def test_fold_bn_to_bias_units_matches_reference():
    from repro.core.mapping import fold_bn_to_bias_units as jfold
    rng = np.random.default_rng(0)
    g = rng.standard_normal(240).astype(np.float32)
    g[:4] = 0.0                                      # the 1e-6 floor
    b, m = (rng.standard_normal(240).astype(np.float32) * 3 for _ in "bm")
    v = (rng.random(240) * 40).astype(np.float32)
    args = (np.abs(g), b, m, v)
    np.testing.assert_allclose(
        fold_bn_to_bias_units(*map(torch.from_numpy, args)).numpy(),
        np.asarray(jfold(*map(jnp.asarray, args))), rtol=1e-6, atol=1e-6)


def test_params_carry_block_bn(setup):
    _, _, _, jp, det, tp, _ = setup
    shapes = det.param_shapes()
    for name, *_ in det.blocks():
        assert set(tp[name]) == set(shapes[name]) == {"w", "bn"}
        for k in ("gamma", "beta", "mean", "var"):
            np.testing.assert_array_equal(tp[name]["bn"][k].numpy(),
                                          np.asarray(jp[name]["bn"][k]))


def test_calibrate_bn_matches_reference(setup):
    _, raw, calib, jp, det, _, _ = setup
    tp = det.calibrate_bn(params_from_jax(jax.device_get(raw), device="cpu"),
                          torch.from_numpy(np.asarray(calib)))
    for part in ["stem_bn"] + [name for name, *_ in det.blocks()]:
        t = tp[part] if part == "stem_bn" else tp[part]["bn"]
        j = jp[part] if part == "stem_bn" else jp[part]["bn"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       rtol=1e-5, atol=1e-5)


def test_group_planes_and_bn_units_match_reference(setup):
    jdet, _, _, jp, det, tp, _ = setup
    for name, _, _, cin, ch in det.blocks():
        cin = max(cin, ch)
        jm = jdet.group_mappings(jp[name], cin, ch)
        tm = det.group_mappings(tp[name], cin, ch)
        assert len(jm) == len(tm) == ch // det.cfg.group
        for a, b in zip(jm, tm):
            assert (b.scheme, b.bias_rows, b.fan_in, b.rows) == (
                a.scheme, a.bias_rows, a.fan_in, a.g_pos.shape[0])
            assert b.bias_rows == det.spec.bn_rows
            np.testing.assert_array_equal(b.g_pos.numpy(),
                                          np.asarray(a.g_pos))
            np.testing.assert_array_equal(b.g_neg.numpy(),
                                          np.asarray(a.g_neg))


def test_chunk_matches_reference(setup):
    """4 chips x 2 images, all effects: the head against the reference's
    plain ensemble route, and no kernel launch on the way."""
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import (_sampled_chunk_forward,
                                      detector_planes as jplanes)
    jdet, _, _, jp, det, tp, ev = setup
    planes, meta = jplanes(jdet, jp)
    ref = np.asarray(_sampled_chunk_forward(
        jp, jnp.asarray(ev.images), jax.random.PRNGKey(5),
        jnp.arange(4, dtype=jnp.uint32), planes, det_cfg=jdet.cfg,
        spec=jdet.spec, cfg_ni=JNI.all(), sa_extra=0.0, meta=meta))
    tpl, tmeta = tmc.detector_planes(det, tp)
    ops.reset_launches()
    out = tmc._sample_and_forward(
        tp, torch.from_numpy(ev.images), prng.PRNGKey(5, device="cpu"),
        torch.arange(4), tpl, det_cfg=det.cfg, spec=det.spec,
        cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=tmeta).numpy()
    assert sum(ops.LAUNCHES.values()) == 0
    assert out.shape == ref.shape == (4, 2) + det.head_geometry()
    assert np.mean(np.abs(out - ref) <= 1e-4) >= 0.99


def test_chip_c_is_single_chip_eval(setup):
    """The eval path's partial sums (`crossbar_forward`) against the
    ensemble's (`ensemble_apply`): chip c of the ensemble is apply(eval)
    with key fold_in(key, c)."""
    _, _, _, _, det, tp, ev = setup
    key = prng.PRNGKey(3, device="cpu")
    images = torch.from_numpy(ev.images)
    ids = torch.tensor([0, 2])
    ens = tmc.build_detector_ensemble(key, det, tp, chip_ids=ids,
                                      cfg=NonidealConfig.all())
    out = det.apply(tp, images, mode="ensemble", ensemble=ens,
                    cfg_ni=NonidealConfig.all())
    for i, c in enumerate(ids.tolist()):
        single = det.apply(tp, images, mode="eval",
                           key=prng.fold_in(key, c),
                           cfg_ni=NonidealConfig.all())
        assert np.mean((out[i] - single).abs().numpy() <= 1e-4) >= 0.99


def test_run_ablation_matches_reference_per_chip(setup):
    from repro.mc.detector_mc import run_ablation_detector as jrun
    from repro.mc.engine import McConfig as JMc
    jdet, _, _, jp, det, tp, ev = setup
    jres = jrun(jax.random.PRNGKey(7), jdet, jp, jnp.asarray(ev.images),
                ev.boxes, ev.classes, mc=JMc(n_chips=3, chunk_size=2))
    ops.reset_launches()
    tres = tmc.run_ablation_detector(
        prng.PRNGKey(7, device="cpu"), det, tp, torch.from_numpy(ev.images),
        ev.boxes, ev.classes, mc=McConfig(n_chips=3, chunk_size=2))
    assert list(tres) == list(jres)
    for name in jres:
        np.testing.assert_allclose(tres[name].per_chip["map50"],
                                   np.asarray(jres[name].per_chip["map50"]),
                                   atol=0.02, err_msg=name)
    assert ops.LAUNCHES["irc_mvm_chips"] == 0


def test_cli_det_scheme_binary(tmp_path, capsys):
    import json
    from repro_torch.launch import mc as cli
    out = tmp_path / "r.json"
    cli.main(["--network", "detector", "--det-scheme", "binary", "--chips",
              "2", "--chunk", "2", "--ablation", "all", "--device", "cpu",
              "--json", str(out), "--run-dir", str(tmp_path)])
    report = json.loads(out.read_text())
    assert report["args"]["det_scheme"] == "binary"
    assert set(report["results"]) == {"init"}
    assert set(report["results"]["init"]) == {"ideal", "all"}
    assert report["kernel_launches"]["irc_mvm_chips"] == 0
    assert "# detector binary 32x32" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not take --det-scheme"):
        cli.main(["--det-scheme", "binary", "--device", "cpu"])
