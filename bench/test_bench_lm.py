"""The LM cell's parts on the CPU: its check reads not correct when the
timed path leaves out the shared experts or drops routed pairs (the cell
at smoke size, as `test_bench_faults.py` runs the others); its readers on
synthetic traced windows; the MACs it counts; and the burst cell's on/off
schedule."""
import argparse
import time

import numpy as np
import pytest
import torch

from benchkit import lm_roofline, main, registry, smoke

torch.set_num_threads(2)
SPEC = registry.load_spec()
LM_CELL = "serve-moonlight-longprompt"


def _run(cell):
    parts = smoke.parts(SPEC, cell)
    args = argparse.Namespace(workload=cell, seed=(1 << 32) + 99,
                              seconds=smoke.seconds(parts), trace=0)
    return main.run_cell(SPEC, parts, args, torch.device("cpu"),
                         time.perf_counter())


def _no_shared_experts(monkeypatch):
    import repro_torch.models.moe as moe
    real = moe.routed_block

    def routed_only(params, x, cfg):
        shared = dict(params["shared"],
                      w_down=torch.zeros_like(params["shared"]["w_down"]))
        return real(dict(params, shared=shared), x, cfg)
    monkeypatch.setattr(moe, "routed_block", routed_only)


def _dropped_pairs(monkeypatch):
    import repro_torch.models.moe as moe
    real = moe.dropless_experts

    def drop_last(xt, weights, idx, *w):
        keep = torch.ones_like(weights)
        keep[::2, -1] = 0.0          # every other token loses a pair
        return real(xt, weights * keep, idx, *w)
    monkeypatch.setattr(moe, "dropless_experts", drop_last)


@pytest.mark.parametrize("fault", [_no_shared_experts, _dropped_pairs],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_moe_reads_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rec = _run(LM_CELL)
    assert not rec["correct"]
    c = rec["checks"]["logits_over_tol"]
    assert c["value"] > c["limit"], rec["checks"]


def _span(name, **ids):
    return {"name": name, "id": 1, "parent": 0, "thread": 1, "start_ns": 0,
            "end_ns": 1, "ids": ids, "counts": {}, "recorded": False}


def _ctx(spans, lengths=(), window_s=10.0):
    trace = {"window_s": window_s, "busy_s": 4.0, "kernels": {},
             "launches": 0, "device_ops": [], "idle_gaps": [],
             "spans": spans}
    cfg = registry.load_config(SPEC, "moonlight-16b-a3b")
    return {"cell": {}, "config": cfg, "traffic": {},
            "window": {"lengths": list(lengths)}, "trace": trace}


READERS = ("prefill_ms_per_ktok.lm", "decode_ms_per_step.lm",
           "mla_share.lm", "expert_imbalance.lm", "lm_mfu")


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_its_spans(name):
    read = registry.load_metric(name).read
    ctx = _ctx([])
    ctx["trace"] = None
    assert read(ctx) is None
    assert read(_ctx([])) is None
    assert read(_ctx([_span("lm_prefill", tokens=100)])) is None


def test_the_readers_on_a_synthetic_window():
    spans = [_span("lm_wave", expert_busiest=30, expert_mean=10.0),
             _span("lm_wave", expert_busiest=50, expert_mean=30.0),
             _span("lm_prefill", tokens=2000, device_ms=40.0),
             _span("lm_prefill", tokens=6000, device_ms=100.0),
             _span("lm_decode", steps=10, device_ms=50.0),
             _span("lm_decode", steps=30, device_ms=110.0),
             _span("mla_attend", kind="prefill", device_ms=30.0),
             _span("mla_attend", kind="prefill", device_ms=40.0),
             _span("mla_attend", kind="decode", device_ms=45.0),
             _span("mla_attend", kind="prefill")]
    read = {n: registry.load_metric(n).read for n in READERS}
    ctx = _ctx(spans, lengths=[(512, 16), (7168, 64)])
    assert read["prefill_ms_per_ktok.lm"](ctx) == pytest.approx(17.5)
    assert read["decode_ms_per_step.lm"](ctx) == pytest.approx(4.0)
    assert read["mla_share.lm"](ctx) == pytest.approx(50.0)
    assert read["expert_imbalance.lm"](ctx) == pytest.approx(2.0)
    macs = (lm_roofline.request_macs(ctx["config"], 512, 16)
            + lm_roofline.request_macs(ctx["config"], 7168, 64))
    assert read["lm_mfu"](ctx) == pytest.approx(
        100 * 2 * macs / 10.0 / 989e12)
    assert registry.load_metric("idle_share.lm").read(ctx) == \
        pytest.approx(60.0)


def test_the_macs_by_hand():
    cfg = registry.load_config(SPEC, "moonlight-16b-a3b")
    assert lm_roofline.token_macs(cfg) == 2_579_103_744
    per_key = 27 * 16 * (128 + 64 + 128)
    assert lm_roofline.context_macs(cfg, 1) == per_key
    # 3 prompt tokens and 2 answer tokens: 4 tokens run, keys 1..4
    assert lm_roofline.request_macs(cfg, 3, 2) == \
        4 * 2_579_103_744 + per_key * (1 + 2 + 3 + 4)


def test_the_burst_schedule_is_on_off_at_the_mean_rate():
    parts = registry.find(SPEC, "serve-proposed-burst")
    tr, arrivals = parts["traffic"], parts["driver"]._steady._arrivals
    t, scenes = arrivals(tr, 5, tr["rate"], 500.0)
    period = tr["on_s"] + tr["off_s"]
    assert ((t % period) < tr["on_s"]).all()
    assert t.size / 500.0 == pytest.approx(tr["rate"], rel=0.05)
    t2, scenes2 = arrivals(tr, 6, tr["rate"], 500.0)
    assert np.array_equal(t, t2) and not np.array_equal(scenes, scenes2)
    # the steady cell's driver keeps its own Poisson schedule
    steady = registry.find(SPEC, "serve-proposed-c8")["driver"]
    assert steady._arrivals is not arrivals
