"""The yardstick's counts on known shapes: K1's least time, the
detector's and the layer's multiply-accumulates, K1's launches a chunk,
and the trace reduction and readers on a timeline written by hand."""
import pytest

from benchkit import readers, registry, roofline
from benchkit.trace import reduce_events

SPEC = registry.load_spec()
DET = registry.load_config(SPEC, "yolo-irc-proposed")
LAYER = registry.load_config(SPEC, "irc-macro-540x60")


def test_k1_least_time_by_hand():
    C, B, R, N = 2, 1000, 572, 60
    product = 2 * C * B * R * N
    t_ops = 2 * product / 1979e12 + 2 * 3 * product / 989e12
    bits = B * R + 2 * R * N + C * B * N               # x, g+/g-, coins
    nbytes = bits / 8 + 4 * (2 * C * R * N + 2 * C * B * N)
    t, by = roofline.k1_least_s(C, B, R, N, per_chip_x=False)
    assert by == "operations" and t == pytest.approx(t_ops, rel=1e-12)
    assert t_ops > nbytes / 3.35e12
    # one vector a die: the bytes bound
    t1, by1 = roofline.k1_least_s(4096, 1, R, N, per_chip_x=True)
    assert by1 == "bytes"


def test_detector_counts():
    macs = (288 * 512 * 60 * 27 + 2 * 288 * 512 * 60 * 540
            + 2 * 144 * 256 * 120 * 540 + 2 * 72 * 128 * 240 * 540
            + 36 * 64 * 240 * 40)
    assert roofline.detector_macs(DET) == macs == 16_982_507_520
    launches = roofline.detector_k1_launches(DET, 4, 8)
    assert len(launches) == 14                 # the program's K1 a chunk
    assert launches[0] == (4, 8 * 288 * 512, 572, 60, False)
    assert launches[1] == (4, 8 * 288 * 512, 572, 60, True)
    assert launches[2:6] == [(4, 8 * 144 * 256, 572, 60, True)] * 4
    assert launches[6:] == [(4, 8 * 72 * 128, 572, 60, True)] * 8


def test_layer_counts():
    assert roofline.layer_macs(LAYER) == 256 * 572 * 60


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction_on_a_timeline():
    events = [_x("kernel", "k1", 0, 10), _x("kernel", "k2", 5, 10),
              _x("gpu_memcpy", "copy", 20, 5),
              _x("cpu_op", "outer", 12, 18), _x("cpu_op", "inner", 16, 2),
              {"ph": "i", "name": "mark", "ts": 3}]
    s = reduce_events(events, 0.0, 40.0)
    assert s["window_s"] == pytest.approx(40e-6)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["launches"] == 2
    assert s["kernels"]["k1"] == [1, pytest.approx(10e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["inner"] == pytest.approx(5e-6)
    assert gaps["host outside any traced op"] == pytest.approx(15e-6)
    ctx = {"trace": s, "window": {"dies": 4}, "config": LAYER,
           "traffic": {"chunk": 1}}
    assert readers.idle_share(ctx) == pytest.approx(50.0)
    assert readers.per_die(ctx, 2.0, 1e3) == pytest.approx(500.0)
    assert readers.k1_share(ctx, 1e-6) is None      # no K1 launch here
    events.append(_x("kernel", "void irc_mvm_chips_kernel<18>", 30, 4))
    s = reduce_events(events, 0.0, 40.0)
    ctx["trace"] = s
    assert readers.k1_share(ctx, 1e-6) == pytest.approx(25.0)
    assert readers.mfu(ctx, 989e12 * 40e-6) == pytest.approx(100.0)
