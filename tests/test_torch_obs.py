"""Run directories, phase timers and convergence telemetry of the port
(`repro_torch.obs`), and the two contracts they exist for:

  * replaying a run's `metrics.jsonl` chunk events through fresh
    StreamingMoments reproduces the reported moments dict for dict (the
    event stream is evidence, not only a log), and
  * a `stderr_target` early-stopped sweep returns the moments of the
    same-length prefix of the full run, for `run_mc` and for
    `run_mc_detector` serial and pipelined alike.

The port's layer CLI and the JAX CLI, run with the same arguments, write
the same event kinds in the same order with the same field names (the
port adds `enqueue_s` to `mc_result`), the same files, and per-chip values
equal up to near-tie decisions."""
import argparse
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.kernels.ref import NEAR_TIE_TOL  # noqa: E402
from repro_torch.launch import mc as tcli  # noqa: E402
from repro_torch.mc import detector_mc as tmc  # noqa: E402
from repro_torch.mc.engine import McConfig, run_mc  # noqa: E402
from repro_torch.mc.ensemble import sample_ensemble  # noqa: E402
from repro_torch.mc.stats import StreamingMoments  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402
from repro_torch.obs import (NULL_RUNLOG, ConvergenceMonitor,  # noqa: E402
                             LatencyTracker, NullRunLog, PhaseTimer, RunLog,
                             as_runlog, collect_env, maybe_runlog,
                             timed_step)
from repro_torch.obs import runlog as runlog_mod  # noqa: E402

torch.set_num_threads(2)


def _events(run):
    return [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]


# ---------------------------------------------------------------- RunLog


class TestRunLog:
    def test_manifest_events_arrays_roundtrip(self, tmp_path):
        rl = RunLog.create("unit", args={"chips": 4,
                                         "arr": torch.arange(2)},
                           root=str(tmp_path), run_id="r1")
        assert rl.path == tmp_path / "r1"
        man = json.loads((rl.path / "manifest.json").read_text())
        assert man["run_id"] == "r1" and man["status"] == "running"
        assert man["args"] == {"chips": 4, "arr": [0, 1]}   # tensor -> list
        assert man["env"]["torch"] == torch.__version__
        assert man["env"]["backend"] == ("cuda" if torch.cuda.is_available()
                                         else "cpu")

        rl.log_event("chunk", chips=2,
                     values={"m": np.float32(0.5),
                             "t": torch.tensor([0.1], dtype=torch.float32)})
        rl.log_event("phase", laps=3)
        evs = _events(rl.path)
        assert [e["kind"] for e in evs] == ["chunk", "phase"]
        assert evs[0]["values"]["m"] == 0.5
        assert np.float32(evs[0]["values"]["t"][0]) == np.float32(0.1)
        assert evs[0]["t"] >= 0.0

        p = rl.save_array("per_chip_m", torch.tensor([1.0, 2.0]))
        np.testing.assert_array_equal(np.load(p), [1.0, 2.0])
        rl.save_result("all", {"m": {"mean": 1.5}},
                       per_chip={"m": np.asarray([1.0, 2.0], np.float32)},
                       chips=2)
        ev = _events(rl.path)[-1]
        assert ev["kind"] == "result" and ev["label"] == "all"
        assert ev["metrics"] == {"m": {"mean": 1.5}} and ev["chips"] == 2
        np.testing.assert_array_equal(
            np.load(rl.path / "per_chip_m_all.npy"), [1.0, 2.0])
        assert rl.write_text("a.csv", "x\n").read_text() == "x\n"

        rl.finalize(status="ok", best=1.5)
        man = json.loads((rl.path / "manifest.json").read_text())
        assert man["status"] == "ok" and man["summary"]["best"] == 1.5
        assert man["wall_s"] >= 0.0

    def test_default_run_id_unique_and_named(self, tmp_path):
        a = RunLog.create("mc", root=str(tmp_path))
        b = RunLog.create("mc", root=str(tmp_path))
        assert a.path != b.path
        assert "-mc-" in a.path.name

    def test_null_runlog_is_silent(self, tmp_path):
        null = as_runlog(None)
        assert null is NULL_RUNLOG and isinstance(null, NullRunLog)
        assert null.path is None
        null.log_event("chunk", chips=2)
        assert null.save_array("x", np.zeros(2)) is None
        assert null.write_text("a.csv", "x") is None
        assert null.start_trace() is False
        null.finalize(status="ok")
        assert list(tmp_path.iterdir()) == []
        assert as_runlog(NULL_RUNLOG) is NULL_RUNLOG

    def test_maybe_runlog(self, tmp_path):
        assert maybe_runlog(False, "x") is NULL_RUNLOG
        rl = maybe_runlog(True, "x", root=str(tmp_path), run_id="y")
        assert rl.path == tmp_path / "y"

    def test_collect_env_names_torch(self):
        env = collect_env()
        for k in ("host", "python", "cpu_count", "torch", "cuda", "backend",
                  "device_count"):
            assert k in env
        assert env["torch"] == torch.__version__
        if not torch.cuda.is_available():
            assert env["backend"] == "cpu" and env["device_count"] == 0

    def test_card_is_none_without_nvidia_smi(self, monkeypatch):
        """No nvidia-smi: the card's name and power limit are None, not a
        guess."""
        def absent(*a, **k):
            raise FileNotFoundError("nvidia-smi")
        monkeypatch.setattr(runlog_mod.subprocess, "run", absent)
        assert runlog_mod._card() == {"gpu_name": None,
                                      "gpu_power_limit": None}

    def test_trace_written_and_errors_logged(self, tmp_path, monkeypatch):
        rl = RunLog.create("u", root=str(tmp_path), run_id="r")
        assert rl.start_trace() is True
        torch.ones(8).add_(1)
        rl.finalize(status="ok")
        trace = json.loads((rl.path / "trace" / "trace.json").read_text())
        assert trace["traceEvents"]

        import torch.profiler as tp

        def refused(*a, **k):
            raise RuntimeError("profiler busy")
        monkeypatch.setattr(tp, "profile", refused)
        rl = RunLog.create("u", root=str(tmp_path), run_id="r2")
        assert rl.start_trace() is False
        rl.stop_trace()
        (ev,) = _events(rl.path)
        assert ev["kind"] == "trace_error" and "profiler busy" in ev["error"]


# ------------------------------------------------- PhaseTimer, latencies


class TestTimers:
    def test_first_lap_is_warmup_rest_steady(self):
        t = PhaseTimer("p", unit="chips")
        for items in (4, 4, 4):
            with t.lap(items=items):
                pass
        assert t.laps == 3
        assert t.compile_items == 4 and t.steady_items == 8
        assert t.total_s == t.compile_s + t.steady_s
        assert t.rate() == 8 / max(t.steady_s, 1e-9)

    def test_single_lap_falls_back_to_total(self):
        t = PhaseTimer("p")
        with t.lap(items=5):
            pass
        assert t.rate() == 5 / max(t.total_s, 1e-9)

    def test_summary_and_log_to(self, tmp_path):
        t = PhaseTimer("decode", unit="tokens")
        with t.lap() as lap:
            lap.items = 2           # known only after the work ran
        s = t.summary()
        assert s["phase"] == "decode" and s["tokens"] == 2
        rl = RunLog.create("u", root=str(tmp_path), run_id="r")
        t.log_to(rl, extra_field=1)
        t.log_to(NULL_RUNLOG)
        (ev,) = _events(rl.path)
        assert ev["kind"] == "phase" and ev["extra_field"] == 1
        assert ev["tokens"] == 2

    def test_timed_step(self):
        t = PhaseTimer("step", unit="steps")
        f = timed_step(lambda x: {"y": [x * 2]}, t)
        for i in range(3):
            assert float(f(torch.tensor(float(i)))["y"][0]) == 2.0 * i
        assert t.laps == 3 and t.steady_items == 2
        g = timed_step(lambda x: (x, 1), t, block_on=lambda out: out[0])
        assert g(torch.ones(1))[1] == 1 and t.laps == 4

    def test_latency_percentiles(self):
        lat = LatencyTracker()
        assert lat.summary() == {"count": 0.0}
        for v in range(1, 101):
            lat.add(v / 100)
        s = lat.summary()
        assert s["count"] == 100.0
        assert math.isclose(s["mean"], 0.505)
        assert math.isclose(s["p50"], 0.505)
        assert math.isclose(s["p95"], np.percentile(np.arange(1, 101) / 100,
                                                    95))
        assert s["p50"] <= s["p95"] <= s["p99"]


# ---------------------------------------------------- ConvergenceMonitor


class TestConvergenceMonitor:
    def test_unknown_metric_rejected(self):
        with pytest.raises(ValueError, match="not a tracked metric"):
            ConvergenceMonitor({"a": StreamingMoments()}, stderr_target=0.1,
                               stderr_metric="b")

    def test_no_target_never_converges_but_logs(self, tmp_path):
        sm = StreamingMoments()
        sm.update(np.asarray([0.1, 0.2, 0.3], np.float32))
        rl = RunLog.create("u", root=str(tmp_path), run_id="r")
        mon = ConvergenceMonitor({"m": sm}, runlog=rl)
        assert mon.after_chunk(0, 3) is False
        (ev,) = _events(rl.path)
        assert ev["kind"] == "convergence" and ev["phase"] == "mc"
        assert ev["metrics"]["m"]["count"] == 3.0
        assert math.isclose(ev["metrics"]["m"]["stderr"], sm.stderr())

    def test_gating_all_vs_single_metric(self):
        tight = StreamingMoments()
        tight.update(np.full((8,), 0.5, np.float32))     # zero spread
        wide = StreamingMoments()
        wide.update(np.asarray([0.0, 1.0, 0.0, 1.0], np.float32))
        both = {"tight": tight, "wide": wide}
        assert ConvergenceMonitor(both, stderr_target=0.01).converged() \
            is False                                 # wide blocks the gate
        assert ConvergenceMonitor(both, stderr_target=0.01,
                                  stderr_metric="tight").converged() is True
        one = StreamingMoments()
        one.update(np.asarray([0.5], np.float32))   # stderr needs 2 chips
        assert ConvergenceMonitor({"m": one},
                                  stderr_target=1.0).converged() is False


# ------------------------------------------------------- run_mc telemetry

CHUNK = 2


def _tiny_run(tmp_path, run_id, **kw):
    args = argparse.Namespace(seed=5, fan_in=64, n_out=16, scheme="ternary",
                              bias_rows=8, batch=8, density=0.5)
    mapped, x, ref = tcli.build_layer(args, "cpu")
    rl = RunLog.create("mc", root=str(tmp_path), run_id=run_id)
    res = run_mc(prng.PRNGKey(42, device="cpu"), mapped, x, ref_bits=ref,
                 mc=McConfig(n_chips=8, chunk_size=CHUNK), obs=rl, **kw)
    return rl, res


def _prefix(per_chip, n):
    """Fresh moments over the first n chips, folded chunk by chunk."""
    sm = StreamingMoments()
    for lo in range(0, n, CHUNK):
        sm.update(per_chip[lo:min(lo + CHUNK, n)])
    return sm


class TestRunMcTelemetry:
    def test_run_emits_events_and_split_timing(self, tmp_path):
        rl, res = _tiny_run(tmp_path, "r1")
        evs = _events(rl.path)
        kinds = [e["kind"] for e in evs]
        assert kinds == (["mc_start"] + ["chunk", "convergence"] * 4
                         + ["mc_result"])
        assert [e["chip_lo"] for e in evs if e["kind"] == "chunk"] == [
            0, 2, 4, 6]
        assert res.n_chips == 8 and res.compile_s > 0.0
        assert res.wall_s >= res.compile_s
        assert evs[-1]["compile_s"] == res.compile_s
        assert evs[-1]["enqueue_s"] == res.enqueue_s
        assert evs[-1]["metrics"] == res.metrics
        assert "steady" in res.summary_line("bit_agreement")

    def test_jsonl_replay_reproduces_moments(self, tmp_path):
        """Chunk events carry the raw float32 per-chip values, which JSON
        round-trips exactly: folding them through fresh StreamingMoments in
        file order gives the reported summary dict for dict."""
        rl, res = _tiny_run(tmp_path, "r2")
        chunk_evs = [e for e in _events(rl.path) if e["kind"] == "chunk"]
        replay = {name: StreamingMoments() for name in chunk_evs[0]["values"]}
        for ev in chunk_evs:
            for name, vals in ev["values"].items():
                replay[name].update(np.asarray(vals, np.float32))
        assert set(replay) == set(res.metrics)
        for name, sm in replay.items():
            assert sm.summary() == res.metrics[name]
            np.testing.assert_array_equal(sm.per_chip, res.per_chip[name])

    def test_early_stop_equals_full_run_prefix(self, tmp_path):
        """With a stderr target the sweep stops at the first chunk boundary
        at or under it, with exactly the moments of the full run's
        same-length prefix."""
        _, full = _tiny_run(tmp_path, "full")
        vals = full.per_chip["bit_agreement"]
        target = _prefix(vals, 2 * CHUNK).stderr()
        stop = next(n for n in range(CHUNK, 9, CHUNK)
                    if _prefix(vals, n).stderr() <= target)
        rl, early = _tiny_run(tmp_path, "early", stderr_target=target,
                              stderr_metric="bit_agreement")
        assert early.n_chips == stop < full.n_chips
        for name in full.metrics:
            sm = _prefix(full.per_chip[name], early.n_chips)
            assert early.metrics[name] == sm.summary()
            np.testing.assert_array_equal(early.per_chip[name], sm.per_chip)
        evs = _events(rl.path)
        assert [e["kind"] for e in evs][-2:] == ["early_stop", "mc_result"]
        assert evs[-2]["chips"] == stop and evs[-2]["requested"] == 8

    def test_no_obs_is_default_and_silent(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        args = argparse.Namespace(seed=5, fan_in=64, n_out=16,
                                  scheme="ternary", bias_rows=8, batch=8,
                                  density=0.5)
        mapped, x, _ = tcli.build_layer(args, "cpu")
        res = run_mc(prng.PRNGKey(0, device="cpu"), mapped, x,
                     mc=McConfig(n_chips=4, chunk_size=2))
        assert res.n_chips == 4
        assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def detector():
    """The smoke-geometry proposed detector, the port's own init with its
    stem BN calibrated, and a 2-image eval batch."""
    det = IRCDetector(tcfg.smoke())
    params = det.init(prng.PRNGKey(0, device="cpu"), device="cpu")
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    params = det.calibrate_bn(
        params, torch.from_numpy(data.batch_for_step(999, 4).images))
    return det, params, data.batch_for_step(1000, 2)


def test_detector_early_stop_serial_and_pipelined(detector, tmp_path):
    """`run_mc_detector` under a stderr target stops at the same chunk
    boundary serial and pipelined (the pipelined sweep drops the chunk it
    has in flight), with per-chip values equal to the full run's prefix."""
    det, params, ev = detector
    key = prng.PRNGKey(7, device="cpu")
    images = torch.from_numpy(ev.images)
    mc = McConfig(n_chips=4, chunk_size=1, cfg=NonidealConfig.all())

    def sweep(pipeline, target=None, run_id=None):
        rl = (RunLog.create("d", root=str(tmp_path), run_id=run_id)
              if run_id else None)
        return rl, tmc.run_mc_detector(key, det, params, images, ev.boxes,
                                       ev.classes, mc=mc, obs=rl,
                                       stderr_target=target,
                                       pipeline=pipeline)

    _, full = sweep(True)
    vals = full.per_chip["map50"]
    target = StreamingMoments()
    target.update(vals[:2])
    stop = next(n for n in range(2, 5)
                if _prefix_detector(vals, n).stderr() <= target.stderr())
    runs = {p: sweep(p, target.stderr(), f"p{int(p)}") for p in (False, True)}
    for rl, res in runs.values():
        assert res.n_chips == stop < full.n_chips
        np.testing.assert_array_equal(res.per_chip["map50"], vals[:stop])
        assert res.metrics == runs[True][1].metrics
        kinds = [e["kind"] for e in _events(rl.path)]
        assert kinds == (["mc_start"] + ["chunk", "convergence"] * stop
                         + ["early_stop", "mc_result"])
    evs = _events(runs[True][0].path)
    assert evs[0]["phase"] == "mc_detector" and evs[0]["pipeline"] is True


def _prefix_detector(vals, n):
    sm = StreamingMoments()
    for v in vals[:n]:
        sm.update(np.asarray([v], np.float32))
    return sm


# ----------------------------------------------------------- the CLIs


SMALL = ["--chips", "4", "--chunk", "2", "--batch", "8", "--fan-in", "32",
         "--n-out", "8", "--bias-rows", "4", "--ablation", "all"]
# run-dir files of SMALL (ablation "all": columns ideal and all)
RUN_FILES = {"manifest.json", "metrics.jsonl", "results.csv", "report.json",
             "per_chip_bit_agreement_ideal.npy",
             "per_chip_bit_agreement_all.npy",
             "per_chip_ones_fraction_ideal.npy",
             "per_chip_ones_fraction_all.npy"}


def test_layer_cli_run_dir(tmp_path, capsys):
    """The port's layer CLI writes its run dir file by file as the JAX
    CLI does; `--out` moves the CSV."""
    tcli.main(SMALL + ["--device", "cpu", "--run-dir", str(tmp_path / "exp"),
                       "--run-id", "cli1"])
    run = tmp_path / "exp" / "cli1"
    assert {p.name for p in run.iterdir()} == RUN_FILES
    man = json.loads((run / "manifest.json").read_text())
    assert man["status"] == "ok" and man["args"]["chips"] == 4
    assert man["summary"] == {"network": "layer", "device_model": "analytic",
                              "t_days": [0.0]}
    assert len(np.load(run / "per_chip_bit_agreement_all.npy")) == 4
    csv = (run / "results.csv").read_text().splitlines()
    assert csv[0].startswith("config,agree_mean")
    assert [line.split(",")[0] for line in csv[1:]] == ["ideal", "all"]
    out = capsys.readouterr().out
    assert "run dir:" in out
    report = json.loads((run / "report.json").read_text())
    assert set(report["results"]) == {"ideal", "all"}
    assert report["run_id"] == "cli1"

    tcli.main(SMALL + ["--device", "cpu", "--run-dir", "", "--out",
                       str(tmp_path / "o.csv")])
    assert (tmp_path / "o.csv").read_text().splitlines()[0] == csv[0]
    assert {p.name for p in tmp_path.iterdir()} == {"exp", "o.csv"}


def test_layer_cli_matches_the_jax_cli_run_dir(tmp_path, monkeypatch,
                                               capsys):
    """Both CLIs with the same small arguments: the same files, event kinds
    in the same order, the same field names per kind (the port adds
    `enqueue_s` to `mc_result`), the same manifest keys (the environment's
    contents exempt), and per-chip values equal up to near-tie decisions."""
    from repro.launch import mc as jcli
    from test_torch_layer_mc import _sa_margin
    monkeypatch.setattr(sys, "argv", ["mc"] + SMALL + [
        "--run-dir", str(tmp_path), "--run-id", "jax"])
    with jax.threefry_partitionable(True), prng.threefry_partitionable(True):
        jcli.main()
        tcli.main(SMALL + ["--device", "cpu", "--run-dir", str(tmp_path),
                           "--run-id", "port"])
        args = argparse.Namespace(seed=0, fan_in=32, n_out=8,
                                  scheme="ternary", bias_rows=4, batch=8,
                                  density=0.5)
        mapped, x, _ = tcli.build_layer(args, "cpu")
        margins = {name: _sa_margin(sample_ensemble(
            prng.PRNGKey(0, device="cpu"), mapped, 4, cfg=cfg), x, cfg,
            "single_shot", 256)
            for name, cfg in (("ideal", NonidealConfig.none()),
                              ("all", NonidealConfig.all()))}
    capsys.readouterr()
    jrun, trun = tmp_path / "jax", tmp_path / "port"
    assert {p.name for p in trun.iterdir()} == {p.name for p in
                                               jrun.iterdir()} == RUN_FILES
    jev, tev = _events(jrun), _events(trun)
    assert [e["kind"] for e in tev] == [e["kind"] for e in jev]
    for j, t in zip(jev, tev):
        extra = {"enqueue_s"} if t["kind"] == "mc_result" else set()
        assert set(t) == set(j) | extra, t["kind"]
    jman = json.loads((jrun / "manifest.json").read_text())
    tman = json.loads((trun / "manifest.json").read_text())
    assert set(tman) == set(jman) and tman["status"] == jman["status"]
    assert tman["summary"] == jman["summary"]
    jcsv = (jrun / "results.csv").read_text().splitlines()
    tcsv = (trun / "results.csv").read_text().splitlines()
    assert tcsv[0] == jcsv[0]
    assert [r.split(",")[0] for r in tcsv] == [r.split(",")[0] for r in jcsv]
    for name, margin in margins.items():
        ties = (margin < NEAR_TIE_TOL).sum(dim=(-2, -1)).numpy()
        for metric in ("bit_agreement", "ones_fraction"):
            f = f"per_chip_{metric}_{name}.npy"
            gap = np.abs(np.load(trun / f) - np.load(jrun / f)) * 8 * 8
            print(f"{name} {metric}: outputs apart per chip "
                  f"{np.round(gap).tolist()}, near-ties {ties.tolist()}")
            assert np.all(np.round(gap) <= ties), f
