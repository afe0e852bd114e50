"""Whole-detector chip-population MC of the port against the JAX package,
on the smoke geometry with the reference's initialized params carried over
by `params_from_jax`.

One chunk (4 chips x 2 images, all effects, same key): head predictions
agree within 1e-4 on >= 99% of elements — the bar the reference sets between
its own two routes — and per-chip mAP@0.5 within 0.02.  Port-only pins:
serial and pipelined sweeps give identical per-chip mAPs, and chip c of the
ensemble is the single-chip eval with key fold_in(key, c)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.mc import detector_mc as tmc  # noqa: E402
from repro_torch.mc.engine import McConfig, TABLE2_ABLATION  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402
from repro_torch.train.det_loss import evaluate_map_per_chip  # noqa: E402

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
    """Reference params (init + calibrate_bn, as the reference's kernel
    tests do), the same params in the port, and a synthetic eval batch."""
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    jdet = JDet(jcfg.smoke("ternary"))
    jp = jdet.init(jax.random.PRNGKey(0))
    calib = jax.random.uniform(jax.random.PRNGKey(1), (4, 32, 32, 3))
    jp = jdet.calibrate_bn(jp, calib)
    det = IRCDetector(tcfg.smoke())
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    ev = data.batch_for_step(1000, 2)
    return jdet, jp, det, tp, ev


def test_chunk_matches_reference(setup):
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import (_sampled_chunk_forward,
                                      detector_planes as jplanes)
    jdet, jp, det, tp, ev = setup
    planes, meta = jplanes(jdet, jp)
    ref = np.asarray(_sampled_chunk_forward(
        jp, jnp.asarray(ev.images), jax.random.PRNGKey(5),
        jnp.arange(4, dtype=jnp.uint32), planes, det_cfg=jdet.cfg,
        spec=jdet.spec, cfg_ni=JNI.all(), sa_extra=0.0, meta=meta,
        use_kernel=True, kernel_impl="ref"))
    tpl, tmeta = tmc.detector_planes(det, tp)
    out = tmc._sample_and_forward(
        tp, torch.from_numpy(ev.images), prng.PRNGKey(5, device="cpu"),
        torch.arange(4), tpl, det_cfg=det.cfg, spec=det.spec,
        cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=tmeta).numpy()
    assert out.shape == ref.shape == (4, 2) + det.head_geometry()
    assert np.mean(np.abs(out - ref) <= 1e-4) >= 0.99
    kw = dict(gt_boxes=ev.boxes, gt_classes=ev.classes,
              n_anchors=det.cfg.n_anchors, n_classes=det.cfg.n_classes)
    np.testing.assert_allclose(evaluate_map_per_chip(out, **kw),
                               evaluate_map_per_chip(ref, **kw), atol=0.02)


def test_data_and_map_match_reference():
    """The numpy-seeded data is bit-identical, and so is the host mAP."""
    from repro.data.detection import render_batch as jrender
    from repro.train.det_loss import evaluate_map_per_chip as jmap
    from repro_torch.data.detection import render_batch
    jb = jrender((64, 96), 3, stride=16, seed=(4, 2))
    tb = render_batch((64, 96), 3, stride=16, seed=(4, 2))
    np.testing.assert_array_equal(np.asarray(jb.images), tb.images)
    for a, b in zip(jb.boxes + jb.classes, tb.boxes + tb.classes):
        np.testing.assert_array_equal(a, b)
    for k, v in tb.targets.items():
        np.testing.assert_array_equal(np.asarray(jb.targets[k]), v)
    preds = np.random.default_rng(0).standard_normal(
        (2, 3, 4, 6, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        jmap(preds, jb.boxes, jb.classes, 5, 3),
        evaluate_map_per_chip(preds, tb.boxes, tb.classes, 5, 3))


def test_ensemble_build_matches_reference_planes(setup):
    """`build_detector_ensemble` draws the reference's dies: every layer/group
    ensemble's effective planes and SA keys at the same chip ids."""
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import build_detector_ensemble as jbuild
    jdet, jp, det, tp, _ = setup
    ids = jnp.asarray([2, 5], dtype=jnp.uint32)
    # jitted, as the reference's sweeps sample (XLA folds the variation
    # sigma into the normal's sqrt(2) there)
    jens = jax.jit(lambda k, p: jbuild(k, jdet, p, chip_ids=ids,
                                       cfg=JNI.all()))(
        jax.random.PRNGKey(9), jp)
    tens = tmc.build_detector_ensemble(prng.PRNGKey(9, device="cpu"), det,
                                       tp, chip_ids=torch.tensor([2, 5]),
                                       cfg=NonidealConfig.all())
    assert set(jens.layers) == set(tens.layers)
    for name, groups in jens.layers.items():
        for jg, tg in zip(groups, tens.layers[name]):
            np.testing.assert_array_equal(tg.ep.numpy(), np.asarray(jg.ep))
            np.testing.assert_array_equal(
                tg.sa_keys.numpy(), np.asarray(jg.sa_keys).astype(np.int64))


@pytest.mark.parametrize("chunk", [2, 3])
def test_serial_and_pipelined_give_identical_chip_maps(setup, chunk):
    _, _, det, tp, ev = setup
    key = prng.PRNGKey(7, device="cpu")
    images = torch.from_numpy(ev.images)
    mc = McConfig(n_chips=5, chunk_size=chunk, cfg=NonidealConfig.all())
    serial = tmc.run_mc_detector(key, det, tp, images, ev.boxes, ev.classes,
                                 mc=mc, pipeline=False)
    piped = tmc.run_mc_detector(key, det, tp, images, ev.boxes, ev.classes,
                                mc=mc, pipeline=True)
    np.testing.assert_array_equal(serial.per_chip["map50"],
                                  piped.per_chip["map50"])
    assert serial.n_chips == piped.n_chips == 5
    assert serial.metrics["map50"] == piped.metrics["map50"]


def test_chip_c_is_single_chip_eval(setup):
    """Chip c of the ensemble path is `apply(mode="eval", key=fold_in(key,
    c))` on the port alone (the two routes' IR-drop formulations differ in
    float32 rounding, so agreement is the near-tie bar)."""
    _, _, det, tp, ev = setup
    key = prng.PRNGKey(3, device="cpu")
    images = torch.from_numpy(ev.images)
    ids = torch.tensor([0, 4])
    ens = tmc.build_detector_ensemble(key, det, tp, chip_ids=ids,
                                      cfg=NonidealConfig.all())
    out = det.apply(tp, images, mode="ensemble", ensemble=ens,
                    cfg_ni=NonidealConfig.all())
    for i, c in enumerate(ids.tolist()):
        single = det.apply(tp, images, mode="eval",
                           key=prng.fold_in(key, c),
                           cfg_ni=NonidealConfig.all())
        assert np.mean((out[i] - single).abs().numpy() <= 1e-4) >= 0.99


def test_ablation_columns_and_ideal_spread(setup):
    _, _, det, tp, ev = setup
    cols = [c for c in TABLE2_ABLATION if c[0] in ("ideal", "all")]
    res = tmc.run_ablation_detector(
        prng.PRNGKey(0, device="cpu"), det, tp, torch.from_numpy(ev.images),
        ev.boxes, ev.classes, ablations=cols,
        mc=McConfig(n_chips=3, chunk_size=2))
    assert list(res) == ["ideal", "all"]
    ideal = res["ideal"].per_chip["map50"]
    assert ideal.shape == (3,) and np.all(ideal == ideal[0])
    for r in res.values():
        assert np.isfinite(r.per_chip["map50"]).all()
        assert set(r.metrics["map50"]) >= {"count", "mean", "std", "q50"}


@pytest.mark.parametrize("pipeline", [True, False])
def test_sweep_timers_cover_every_enqueue(setup, pipeline):
    _, _, det, tp, ev = setup
    r = tmc.run_mc_detector(
        prng.PRNGKey(0, device="cpu"), det, tp, torch.from_numpy(ev.images),
        ev.boxes, ev.classes, mc=McConfig(n_chips=3, chunk_size=1),
        pipeline=pipeline)
    # the enqueue, wait and scoring laps nest inside the chunk laps
    assert r.enqueue_s > 0 and r.host_s > 0
    assert r.enqueue_s + r.device_s + r.host_s <= r.wall_s
    assert r.compile_s < r.wall_s


def test_out_of_slice_paths_raise(setup):
    from repro_torch.device.base import DeviceModel
    from repro_torch.mc.engine import ensemble_apply_kernel
    _, _, det, tp, ev = setup
    images = torch.from_numpy(ev.images)
    with pytest.raises(ValueError, match="unknown mode"):
        det.apply(tp, images, mode="qat")
    with pytest.raises(ValueError, match="kernel_impl"):
        det.apply(tp, images, mode="ensemble", kernel_impl="pallas",
                  ensemble=tmc.build_detector_ensemble(
                      prng.PRNGKey(0, device="cpu"), det, tp, 1))

    class OwnPeriphery(DeviceModel):
        name = "own"
        analytic_periphery = False

        def variation_mask(self, key, shape, spec=None):
            return torch.ones(shape)

        def hrs_leak_units(self, spec=None):
            return 0.0

    ens = tmc.build_detector_ensemble(prng.PRNGKey(0, device="cpu"), det, tp,
                                      1).layers["s0b0"][0]
    with pytest.raises(NotImplementedError, match="non-analytic"):
        ensemble_apply_kernel(ens, torch.zeros((4, 540)),
                              cfg=NonidealConfig.all(), device=OwnPeriphery())


def test_entry_points_default_to_the_card(setup):
    _, _, det, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        det.init(prng.PRNGKey(0, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(3)})


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    import json
    from repro_torch.launch import mc as cli
    out = tmp_path / "r.json"
    cli.main(["--network", "detector", "--chips", "2", "--chunk", "2",
              "--ablation", "all", "--device", "cpu", "--json", str(out),
              "--run-dir", str(tmp_path)])
    report = json.loads(out.read_text())
    assert set(report["results"]) == {"init"}     # no QAT: the seed's init
    assert set(report["results"]["init"]) == {"ideal", "all"}
    assert report["kernel_launches"]["irc_mvm_chips"] == 0   # CPU: plain
    assert "ideal" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--ablation", "nope", "--device", "cpu"])
