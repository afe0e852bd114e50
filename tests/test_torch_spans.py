"""Spans and counters of the port (`repro_torch.obs.spans`): off (no
profiler trace) they record nothing and enter no `record_function`; under
a CPU `torch.profiler` they nest, carry their ids and counters, keep to the
buffer's bound, and the spans of a thread the profiler does not record
(the detector service's scheduler) land on the trace's clock through the
spans recorded both ways.  The sweeps give one span of each kind per
chunk."""
import argparse
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd.profiler import record_function  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.launch import mc as tcli  # noqa: E402
from repro_torch.mc.detector_mc import run_mc_detector  # noqa: E402
from repro_torch.mc.engine import McConfig, run_mc  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402
from repro_torch.obs import PhaseTimer, RunLog, spans  # noqa: E402
from repro_torch.serve import DetectorServeEngine  # noqa: E402
from repro_torch.train.det_loss import (decode_detections,  # noqa: E402
                                        evaluate_map_per_chip)

torch.set_num_threads(2)
TIMEOUT_S = 120


def _cpu_trace():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(found):
    out = {}
    for s in found:
        out.setdefault(s["name"], []).append(s)
    return out


def _layer():
    args = argparse.Namespace(seed=5, fan_in=64, n_out=16, scheme="ternary",
                              bias_rows=8, batch=8, density=0.5)
    return tcli.build_layer(args, "cpu")


@pytest.fixture(scope="module")
def detector():
    """The smoke-geometry proposed detector (the port's own init, stem BN
    calibrated) and a 2-image batch."""
    det = IRCDetector(tcfg.smoke())
    params = det.init(prng.PRNGKey(0, device="cpu"), device="cpu")
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors, seed=1)
    params = det.calibrate_bn(
        params, torch.from_numpy(data.batch_for_step(999, 4).images))
    return det, params, data.batch_for_step(1000, 2)


def test_off_records_nothing_and_enters_no_range(monkeypatch, detector):
    """With no trace running, spans, counters, timer laps, a sweep and the
    decoders record nothing, enter no `record_function` and read no
    nanosecond clock."""
    det, params, ev = detector
    entered, clock = [], []
    real_rf, real_ns = record_function, time.perf_counter_ns

    def counting_rf(*a, **k):
        entered.append(a)
        return real_rf(*a, **k)

    def counting_ns():
        clock.append(1)
        return real_ns()

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting_rf)
    monkeypatch.setattr(spans.time, "perf_counter_ns", counting_ns)
    spans.drain_spans()
    assert not spans.spans_on()
    assert spans.span("x", chunk=0) is spans.OFF
    with spans.span("x") as sp:
        sp.set(device_ms=1.0)
        spans.count("boxes", 3)
    spans.close_span("queued", 0, request=1)
    t = PhaseTimer("p")
    with t.lap(items=1, chunk=0) as lap:
        assert lap.span is spans.OFF
    mapped, x, ref = _layer()
    run_mc(prng.PRNGKey(1, device="cpu"), mapped, x, ref_bits=ref,
           mc=McConfig(n_chips=4, chunk_size=2))
    preds = np.zeros((1, 2) + (4, 4, det.cfg.n_anchors
                               * (5 + det.cfg.n_classes)), np.float32)
    evaluate_map_per_chip(preds, ev.boxes, ev.classes, det.cfg.n_anchors,
                          det.cfg.n_classes)
    decode_detections(preds[0, 0], det.cfg.n_anchors, det.cfg.n_classes)
    assert spans.drain_spans() == ([], 0)
    assert entered == [] and clock == []


def test_spans_nest_carry_ids_and_keep_to_the_bound(monkeypatch, tmp_path):
    spans.drain_spans()
    t0 = time.perf_counter_ns()
    with _cpu_trace() as prof:
        assert spans.spans_on()
        with spans.span("outer", call=3) as outer:
            with spans.span("inner", chunk=1, chip_lo=4) as inner:
                spans.count("boxes", 2)
                spans.count("boxes")
            inner.set(device_ms=0.5)
            spans.close_span("queued", t0, request=9)
    found, dropped = spans.drain_spans()
    assert dropped == 0
    got = _by_name(found)
    (o,), (i,), (q,) = got["outer"], got["inner"], got["queued"]
    assert o["parent"] == 0 and i["parent"] == o["id"] == q["parent"]
    assert o["ids"] == {"call": 3}
    assert i["ids"] == {"chunk": 1, "chip_lo": 4, "device_ms": 0.5}
    assert i["counts"] == {"boxes": 3} and o["counts"] == {}
    assert q["ids"] == {"request": 9} and q["start_ns"] == t0
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]
    assert {s["thread"] for s in found} == {threading.get_native_id()}
    assert o["recorded"] and i["recorded"] and not q["recorded"]
    assert (outer.ident, inner.ident) == (o["id"], i["id"])
    assert [s["name"] for s in found] == ["inner", "queued", "outer"]

    # the recorded ranges place the unrecorded span on the trace's clock
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= set(ranges)
    extra, offset = spans.trace_events(events, found)
    assert offset is not None
    (e,) = extra
    assert e["name"] == "queued" and e["cat"] == "user_annotation"
    assert e["args"]["request"] == 9 and e["args"]["span_parent"] == o["id"]
    assert e["ts"] < ranges["outer"]["ts"]        # submitted before it
    assert e["ts"] + e["dur"] == pytest.approx(
        ranges["outer"]["ts"] + ranges["outer"]["dur"], abs=1e3)
    # with nothing recorded both ways there is no clock to place it by
    assert spans.trace_events(events, [q]) == ([], None)
    assert spans.trace_events([], found) == ([], None)

    monkeypatch.setattr(spans, "MAX_SPANS", 3)
    with _cpu_trace():
        for k in range(5):
            with spans.span("s", k=k):
                pass
    found, dropped = spans.drain_spans()
    assert [s["ids"]["k"] for s in found] == [0, 1, 2] and dropped == 2
    assert spans.drain_spans() == ([], 0)


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores record spans at once, with the interpreter
    switching threads often: every span is kept or counted as dropped,
    each id once, each parent on its own thread."""
    import os
    import sys
    n_threads, per = 2 * (os.cpu_count() or 2) + 2, 300
    monkeypatch.setattr(spans, "MAX_SPANS", n_threads * per)
    spans.drain_spans()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for k in range(per // 2):
            with spans.span("outer", k=k):
                with spans.span("inner", k=k):
                    spans.count("n")
    try:
        with _cpu_trace():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    found, dropped = spans.drain_spans()
    assert dropped == 0 and len(found) == n_threads * per
    assert len({s["id"] for s in found}) == len(found)
    outer = {s["id"]: s for s in found if s["name"] == "outer"}
    for s in found:
        if s["name"] == "inner":
            assert outer[s["parent"]]["thread"] == s["thread"]
            assert s["counts"] == {"n": 1}
    monkeypatch.setattr(spans, "MAX_SPANS", per)
    with _cpu_trace():
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
    found, dropped = spans.drain_spans()
    assert len(found) == per and dropped == 3 * per


def test_trace_offset_is_the_median_over_anchors():
    """Each name's ranges and spans pair in time order where their numbers
    agree; a name whose numbers differ gives no anchor."""
    def rng(name, ts):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": 1.0, "pid": 7, "tid": 1}

    def sp(name, start_us, recorded=True, **ids):
        return {"name": name, "id": 1, "parent": 0, "thread": 42,
                "start_ns": int(start_us * 1e3),
                "end_ns": int(start_us * 1e3) + 2000, "ids": ids,
                "counts": {"boxes": 1}, "recorded": recorded}

    events = [rng("a", 1010.0), rng("a", 1020.0), rng("a", 1031.0),
              rng("b", 5000.0)]
    found = [sp("a", 10.0), sp("a", 20.0), sp("a", 30.0),
             sp("b", 1.0), sp("b", 2.0), sp("late", 100.0, False, wave=2)]
    extra, offset = spans.trace_events(events, found)
    assert offset == pytest.approx(1000.0)
    (e,) = extra
    assert e["ts"] == pytest.approx(1100.0) and e["dur"] == pytest.approx(2)
    assert (e["pid"], e["tid"]) == (7, 42)
    assert e["args"] == {"wave": 2, "boxes": 1, "span_id": 1,
                         "span_parent": 0}


def test_service_scheduler_spans_on_the_trace_clock(tmp_path, detector):
    """An engine started before the trace: `RunLog.stop_trace` writes its
    scheduler's idle, enqueue, copy-wait and decode spans into trace.json
    between the window's marks, on the scheduler's own tid; every answered
    request has a queue span and then a respond span with its id."""
    det, params, ev = detector
    eng = DetectorServeEngine(det, params, committee=2, batch_slots=2)
    eng.serve_batch([ev.images[0]])                # warm
    eng.start()
    tid = eng._thread.native_id
    rl = RunLog.create("s", root=str(tmp_path), run_id="r")
    try:
        assert rl.start_trace()
        with record_function("window_start"):
            pass
        rids = [eng.submit(ev.images[i % 2]) for i in range(3)]
        for r in rids:
            eng.result(r, timeout=TIMEOUT_S)
        time.sleep(0.05)                           # the scheduler idles
        rids += [eng.submit(ev.images[0])]
        eng.result(rids[-1], timeout=TIMEOUT_S)
        with record_function("window_end"):
            pass
        rl.stop_trace()
    finally:
        eng.stop()
    events = json.loads((rl.path / "trace" / "trace.json").read_text())[
        "traceEvents"]
    marks = {e["name"]: e["ts"] for e in events
             if e.get("name") in ("window_start", "window_end")}
    lo, hi = marks["window_start"], marks["window_end"]
    mine = [e for e in events if e.get("tid") == tid
            and e.get("cat") == "user_annotation"]
    for e in mine:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
    names = {e["name"] for e in mine}
    assert {"serve_idle", "serve_enqueue", "serve_copy_wait", "serve_host",
            "serve_wave", "serve_respond", "serve_queue"} <= names
    for r in rids:
        (q,) = [e for e in mine if e["name"] == "serve_queue"
                and e["args"]["request"] == r]
        (a,) = [e for e in mine if e["name"] == "serve_respond"
                and e["args"]["request"] == r]
        assert q["ts"] + q["dur"] <= a["ts"]
        assert q["args"]["wave"] == a["args"]["wave"]
        assert a["args"]["images"] == 3           # the mean and 2 dies
    waves = [e for e in mine if e["name"] == "serve_wave"]
    assert sorted(e["args"]["lanes"] for e in waves) == [1, 1, 2]
    assert all(e["args"]["depth"] >= e["args"]["lanes"] for e in waves)
    submits = [e for e in events if e.get("name") == "submit"]
    assert len(submits) == 4 and all(e["tid"] != tid for e in submits)


def test_serve_cli_trace_holds_the_scheduler_spans(tmp_path):
    from repro_torch.launch import serve as cli
    cli.main(["--network", "detector", "--device", "cpu", "--requests", "3",
              "--slots", "2", "--committee", "2", "--run-dir",
              str(tmp_path), "--run-id", "t", "--trace"])
    trace = json.loads((tmp_path / "t" / "trace" / "trace.json").read_text())
    waves = [e for e in trace["traceEvents"]
             if e.get("name") == "serve_wave"]
    assert sum(e["args"]["lanes"] for e in waves) == 3
    evs = [json.loads(line) for line in
           (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    assert not [e for e in evs if e["kind"] == "trace_error"]


def _layer_sweep(detector):
    mapped, x, ref = _layer()
    run_mc(prng.PRNGKey(3, device="cpu"), mapped, x, ref_bits=ref,
           mc=McConfig(n_chips=7, chunk_size=2))
    return "mc", 7, 2, None


def _detector_sweep(detector):
    det, params, ev = detector
    run_mc_detector(prng.PRNGKey(3, device="cpu"), det, params,
                    torch.from_numpy(ev.images), ev.boxes, ev.classes,
                    mc=McConfig(n_chips=3, chunk_size=2,
                                cfg=NonidealConfig.all()))
    return "mc_detector", 3, 2, len(ev.images)


@pytest.mark.parametrize("sweep", [_layer_sweep, _detector_sweep],
                         ids=["run_mc", "run_mc_detector"])
def test_sweeps_give_one_span_of_each_kind_per_chunk(sweep, detector):
    spans.drain_spans()
    with _cpu_trace():
        phase, n_chips, chunk, images = sweep(detector)
    found, dropped = spans.drain_spans()
    assert dropped == 0
    got = _by_name(found)
    (call,) = got[f"{phase}_call"]
    assert call["ids"] == {"chips": n_chips, "chunk_size": chunk}
    los = list(range(0, n_chips, chunk))
    for kind in ("chunks", "enqueue", "copy_wait", "host"):
        assert [(s["ids"]["chunk"], s["ids"]["chip_lo"])
                for s in sorted(got[f"{phase}_{kind}"],
                                key=lambda s: s["start_ns"])] == list(
            enumerate(los)), kind
    for s in got[f"{phase}_chunks"]:
        assert s["parent"] == call["id"]
        assert s["ids"]["chips"] == min(chunk, n_chips - s["ids"]["chip_lo"])
        assert "device_ms" not in s["ids"]          # no card here
    hosts = {s["id"]: s for s in got[f"{phase}_host"]}
    if images is None:
        assert "score_map" not in got
        return
    scores = got["score_map"]
    assert len(scores) == len(los)
    for s in scores:
        host = hosts[s["parent"]]
        assert s["ids"]["chips"] == min(chunk, n_chips - host["ids"][
            "chip_lo"])
        assert s["counts"]["images"] == s["ids"]["chips"] * images
        assert 0 <= s["counts"]["boxes_kept"] <= s["counts"]["boxes_passed"]
