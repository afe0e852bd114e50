"""The readers of the program's spans (`benchkit/spans.py`) on synthetic
traced windows: each reads its number from the spans handed over under
`ctx["trace"]["spans"]`, drains the program's buffer where that list is
missing, and returns None without a trace, without spans, or where the
program has no span buffer."""
import sys

import numpy as np
import pytest

from benchkit import registry

NEW = ("spare_share.serve", "queue_ms_p95.serve", "wave_device_ms.serve",
       "device_ms_per_die.det", "device_us_per_die.layer")


def _span(name, start_s, length_s, **ids):
    return {"name": name, "id": 1, "parent": 0, "thread": 1,
            "start_ns": int(start_s * 1e9),
            "end_ns": int((start_s + length_s) * 1e9), "ids": ids,
            "counts": {}, "recorded": False}


def _ctx(spans=None, dies=8, window_s=5.0):
    trace = {"window_s": window_s, "busy_s": 1.0, "kernels": {},
             "launches": 0, "device_ops": [], "idle_gaps": []}
    if spans is not None:
        trace["spans"] = spans
    return {"cell": {}, "config": {}, "traffic": {},
            "window": {"dies": dies}, "trace": trace}


@pytest.fixture
def empty_buffer():
    from repro_torch.obs import spans
    spans.drain_spans()


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_reads_none_without_spans(name, empty_buffer,
                                               monkeypatch):
    read = registry.load_metric(name).read
    ctx = _ctx()
    ctx["trace"] = None
    assert read(ctx) is None                 # untraced
    assert read(_ctx()) is None              # the program recorded none
    assert read(_ctx([])) is None
    assert read(_ctx([_span("unrelated", 0.0, 1.0)])) is None
    # a program without a span buffer, as before spans existed
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    ctx = _ctx()
    assert read(ctx) is None and ctx["trace"]["spans"] is None


def test_the_new_readers_on_a_synthetic_window(empty_buffer):
    serve = [_span("serve_wave", 0.0, 0.2, wave=1, device_ms=10.0),
             _span("serve_wave", 0.3, 0.2, wave=2, device_ms=20.0),
             _span("serve_wave", 0.6, 0.1, wave=3),
             _span("serve_idle", 1.0, 0.5), _span("serve_idle", 2.0, 0.25),
             _span("serve_queue", 0.0, 0.010, request=1),
             _span("serve_queue", 0.0, 0.030, request=2),
             _span("serve_queue", 0.0, 0.500, request=3),
             _span("serve_respond", 0.4, 0.01, request=1),
             _span("serve_respond", 0.5, 0.01, request=2)]
    read = {n: registry.load_metric(n).read for n in NEW}
    ctx = _ctx(serve)
    assert read["spare_share.serve"](ctx) == pytest.approx(15.0)
    assert read["queue_ms_p95.serve"](ctx) == pytest.approx(
        np.percentile([10.0, 30.0], 95))
    assert read["wave_device_ms.serve"](ctx) == pytest.approx(15.0)
    assert read["device_ms_per_die.det"](ctx) is None
    # no wave at all: the service ran nothing in the window
    assert read["spare_share.serve"](_ctx(serve[3:5])) is None

    det = [_span("mc_detector_chunks", 0.0, 0.2, chunk=0, device_ms=100.0),
           _span("mc_detector_chunks", 0.2, 0.4, chunk=1, device_ms=300.0),
           _span("mc_detector_enqueue", 0.0, 0.1, chunk=0)]
    assert read["device_ms_per_die.det"](_ctx(det, dies=8)) == \
        pytest.approx(50.0)
    layer = [_span("mc_chunks", 0.0, 0.01, chunk=k, device_ms=2.0)
             for k in range(2)]
    assert read["device_us_per_die.layer"](_ctx(layer, dies=4096)) == \
        pytest.approx(4.0 / 4096 * 1e3)
    assert read["device_us_per_die.layer"](_ctx(layer, dies=0)) is None


def test_the_first_reader_drains_the_program_buffer(empty_buffer):
    """Spans recorded under a profiler reach the readers through the
    program's buffer, once: the list is kept in the trace summary."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("serve_wave", wave=1) as sp:
            sp.set(device_ms=4.0)
    ctx = _ctx()
    read = registry.load_metric("wave_device_ms.serve").read
    assert read(ctx) == pytest.approx(4.0)
    assert [s["name"] for s in ctx["trace"]["spans"]] == ["serve_wave"]
    assert spans.drain_spans() == ([], 0)
    assert read(ctx) == pytest.approx(4.0)
