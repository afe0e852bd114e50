"""Population-aware detector serving in the port (`repro_torch.serve`), at
the smoke geometry with the JAX package's initialized params carried over
by `params_from_jax`.

A request's committee is keyed by the stateless coordinate fold_in(root,
request_id): its draws do not depend on the requests before it or in its
wave, and each lane is bit-identical to the port's own MC chunk forward
`_sample_and_forward` (and so to `run_mc_detector`) at that key.  Against
the JAX engine the committees agree at the detector-MC bar (>= 99% of
elements within 1e-4; the two packages add the digital stem and head in
other orders) and each request's confidence mean within 0.02."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.mc.detector_mc import (_sample_and_forward,  # noqa: E402
                                        detector_planes, run_mc_detector)
from repro_torch.mc.engine import McConfig  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402
from repro_torch.serve import (DetectionResponse,  # noqa: E402
                               DetectorServeEngine, PAD_REQUEST_ID,
                               ServeQueueFull)
from repro_torch.train.det_loss import (decode_detections,  # noqa: E402
                                        evaluate_map_per_chip)

torch.set_num_threads(2)

SEED = 11
COMMITTEE = 2
SLOTS = 2
N_REQUESTS = 5
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this
    module's tests, the earlier settings restored after them."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


def _engine(det, params, **kw):
    kw.setdefault("committee", COMMITTEE)
    kw.setdefault("batch_slots", SLOTS)
    kw.setdefault("seed", SEED)
    kw.setdefault("keep_committee", True)
    return DetectorServeEngine(det, params, **kw)


@pytest.fixture(scope="module")
def served():
    """The reference's detector (init PRNGKey(0), stem BN calibrated on 6
    synthetic images of seed 1), the same params in the port, and the
    port's synchronous serve_batch of 5 requests: waves of 2, 2 and 1."""
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    jdet = JDet(jcfg.smoke("ternary"))
    det = IRCDetector(tcfg.smoke())
    data = SyntheticDetectionData(det.cfg.img_hw, det.cfg.n_classes,
                                  det.cfg.n_anchors, det.cfg.strides, seed=1)
    batch = data.batch_for_step(0, 6)
    jp = jdet.calibrate_bn(jdet.init(jax.random.PRNGKey(0)),
                           jax.numpy.asarray(batch.images))
    params = params_from_jax(jax.device_get(jp), device="cpu")
    eng = _engine(det, params)
    responses = eng.serve_batch([batch.images[i] for i in range(N_REQUESTS)])
    return jdet, jp, det, params, batch, eng, responses


def _chunk_forward(det, params, image, rid):
    """The MC chunk forward of one image at key fold_in(root, rid), chip
    ids 0..COMMITTEE-1: [chips, gh, gw, ho]."""
    planes, meta = detector_planes(det, params)
    key = prng.fold_in(prng.PRNGKey(SEED, device="cpu"), rid)
    return _sample_and_forward(
        params, torch.from_numpy(image[None]), key, torch.arange(COMMITTEE),
        planes, det_cfg=det.cfg, spec=det.spec, cfg_ni=NonidealConfig.all(),
        sa_extra=0.0, meta=meta)[:, 0].numpy()


class TestStatelessKeys:
    def test_committee_bit_identical_to_chunk_forward(self, served):
        """Every lane, those of the short last wave too, equals the MC
        chunk forward at key fold_in(root, request_id)."""
        _, _, det, params, batch, _, responses = served
        for r in responses:
            np.testing.assert_array_equal(
                r.committee,
                _chunk_forward(det, params, batch.images[r.request_id],
                               r.request_id))

    def test_committee_bit_identical_to_run_mc_detector(self, served):
        """A response's per-chip mAPs are run_mc_detector's at the same
        root/request key and chip ids (committee == n_chips)."""
        _, _, det, params, batch, _, responses = served
        rid = 3
        gt_b, gt_c = [batch.boxes[rid]], [batch.classes[rid]]
        res = run_mc_detector(
            prng.fold_in(prng.PRNGKey(SEED, device="cpu"), rid), det, params,
            torch.from_numpy(batch.images[rid][None]), gt_b, gt_c,
            mc=McConfig(n_chips=COMMITTEE, chunk_size=COMMITTEE,
                        cfg=NonidealConfig.all()))
        mine = evaluate_map_per_chip(responses[rid].committee[:, None],
                                     gt_b, gt_c, det.cfg.n_anchors,
                                     det.cfg.n_classes)
        np.testing.assert_array_equal(mine, res.per_chip["map50"])

    def test_draws_independent_of_earlier_requests(self, served):
        """A request served after other traffic, in another wave
        composition and slot count, keeps its committee bit for bit."""
        _, _, det, params, batch, _, responses = served
        imgs = batch.images
        # rid 3 carrying another image, first request of a 1-slot engine:
        # the keyed forward of that image at rid 3
        eng = _engine(det, params, batch_slots=1)
        eng.submit(imgs[5], request_id=3)
        eng.process_pending()
        np.testing.assert_array_equal(eng.result(3).committee,
                                      _chunk_forward(det, params, imgs[5], 3))
        # the batch-served rid 3 (a wave of 2, after 2 earlier requests)
        # equals a 1-slot engine serving the same image as rid 3 alone
        eng = _engine(det, params, batch_slots=1)
        eng.submit(imgs[3], request_id=3)
        eng.process_pending()
        np.testing.assert_array_equal(eng.result(3).committee,
                                      responses[3].committee)

    def test_async_scheduler_matches_sync(self, served):
        """The background scheduler forms waves by arrival, but the
        stateless keys make every response the sync path's."""
        _, _, det, params, batch, _, responses = served
        eng = _engine(det, params)
        eng.start()
        try:
            rids = [eng.submit(batch.images[i]) for i in range(N_REQUESTS)]
            got = [eng.result(rid, timeout=TIMEOUT_S) for rid in rids]
        finally:
            eng.stop()
        assert eng._thread is None
        for a, b in zip(got, responses):
            assert a.request_id == b.request_id
            np.testing.assert_array_equal(a.committee, b.committee)
            assert a.confidence == b.confidence


    def test_aged_measured_device_lane_is_the_chunk_forward(self, served):
        """An engine serving from an aged, measured device (measured@t30d):
        its committee for request 2 is the MC chunk forward at key
        fold_in(root, 2) on the same device, bit for bit, and differs from
        the analytic device's."""
        from repro_torch.device import get_device_model
        _, _, det, params, batch, _, responses = served
        device = get_device_model("measured", t_days=30)
        eng = _engine(det, params, batch_slots=1, device=device)
        eng.submit(batch.images[2], request_id=2)
        eng.process_pending()
        got = eng.result(2).committee
        planes, meta = detector_planes(det, params)
        want = _sample_and_forward(
            params, torch.from_numpy(batch.images[2][None]),
            prng.fold_in(prng.PRNGKey(SEED, device="cpu"), 2),
            torch.arange(COMMITTEE), planes, det_cfg=det.cfg, spec=det.spec,
            cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta,
            device=device)[:, 0].numpy()
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, responses[2].committee)


class TestResponses:
    def test_confidence_population_stats(self, served):
        responses = served[-1]
        for r in responses:
            c = r.confidence
            assert c["count"] == COMMITTEE
            assert 0.0 <= c["mean"] <= 1.0 and c["std"] >= 0.0
            assert set(c) >= {"q05", "q25", "q50", "q75", "q95"}
            assert c["q05"] <= c["q50"] <= c["q95"]

    def test_detections_decoded_from_committee_mean(self, served):
        _, _, det, _, _, eng, responses = served
        r = responses[0]
        _, scores, _ = decode_detections(
            r.committee.mean(axis=0), det.cfg.n_anchors, det.cfg.n_classes,
            eng.conf_thresh, eng.nms_thresh)
        assert len(r.detections) == len(scores)
        got = np.array([d.score for d in r.detections], np.float32)
        np.testing.assert_array_equal(got, scores.astype(np.float32))

    def test_response_metadata(self, served):
        eng, responses = served[-2:]
        assert [r.request_id for r in responses] == list(range(N_REQUESTS))
        # 5 requests at 2 slots -> waves of 2/2/1
        assert [r.wave for r in responses] == [1, 1, 2, 2, 3]
        assert all(r.queue_s > 0 for r in responses)
        stats = eng.stats()
        lat = stats["queue_latency"]
        assert lat["count"] == N_REQUESTS and lat["p50"] <= lat["p95"]
        assert stats["wave"]["laps"] == 3 and stats["enqueue"]["laps"] == 3


class TestAdmissionControl:
    def test_queue_full_rejects(self, served):
        _, _, det, params, batch, _, _ = served
        img = batch.images[0]
        eng = _engine(det, params, max_queue=2)
        eng.submit(img)
        eng.submit(img)
        with pytest.raises(ServeQueueFull):
            eng.submit(img)
        assert eng.process_pending() == 2      # draining frees capacity
        eng.submit(img)

    def test_request_id_validation(self, served):
        _, _, det, params, batch, _, _ = served
        img = batch.images[0]
        eng = _engine(det, params)
        with pytest.raises(ValueError):
            eng.submit(img, request_id=PAD_REQUEST_ID)
        with pytest.raises(ValueError):
            eng.submit(img, request_id=-1)
        eng.submit(img, request_id=7)
        with pytest.raises(ValueError):        # duplicate in-flight id
            eng.submit(img, request_id=7)
        eng.process_pending()
        assert isinstance(eng.result(7, timeout=TIMEOUT_S),
                          DetectionResponse)
        with pytest.raises(TimeoutError):
            eng.submit(img, request_id=8)
            eng.result(8, timeout=0.01)        # nothing drains the queue


def test_committee_matches_the_jax_engine(served):
    """The JAX engine on the same params, images, seed, committee and
    slots (its kernel route through the oracle `kernel_impl="ref"`, the
    kernel's bit-exactness contract): every committee within 1e-4 on >= 99%
    of elements, each confidence mean within 0.02."""
    from repro.serve import DetectorServeEngine as JEngine
    jdet, jp, _, _, batch, _, responses = served
    jeng = JEngine(jdet, jp, committee=COMMITTEE, batch_slots=SLOTS,
                   seed=SEED, keep_committee=True, use_kernel=True,
                   kernel_impl="ref")
    ref = jeng.serve_batch([batch.images[i] for i in range(N_REQUESTS)])
    got = np.stack([r.committee for r in responses])
    want = np.stack([r.committee for r in ref])
    assert got.shape == want.shape
    close = float(np.mean(np.abs(got - want) <= 1e-4))
    same = float(np.mean(got == want))
    print(f"committees: {close:.6f} within 1e-4, {same:.6f} bit-identical")
    assert close >= 0.99
    for a, b in zip(responses, ref):
        assert a.request_id == b.request_id and a.wave == b.wave
        assert abs(a.confidence["mean"] - b.confidence["mean"]) <= 0.02


def test_cli_serves_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--network", "detector", "--device", "cpu", "--requests", "3",
              "--slots", "2", "--committee", "2", "--run-dir",
              str(tmp_path), "--run-id", "s"])
    run = tmp_path / "s"
    man = json.loads((run / "manifest.json").read_text())
    assert man["status"] == "ok" and man["summary"]["requests"] == 3
    evs = [json.loads(line) for line in
           (run / "metrics.jsonl").read_text().splitlines()]
    waves = [e for e in evs if e["kind"] == "serve_wave"]
    assert sum(e["requests"] for e in waves) == 3
    assert {"device_s", "host_s", "enqueue_s", "queue_s"} <= set(waves[0])
    assert [e["kind"] for e in evs[-5:]] == ["phase"] * 4 + ["serve_latency"]
    out = capsys.readouterr().out
    assert "3 requests over 2-chip committees" in out
    # --network lm, the JAX CLI's default, serves the LM (it once exited)
    cli.main(["--network", "lm", "--device", "cpu", "--requests", "1",
              "--max-new", "2"])
    assert "1 requests, 2 new tokens" in capsys.readouterr().out
