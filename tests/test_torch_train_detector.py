"""The port's paper-task driver `repro_torch.examples.train_detector`
against the JAX package's `examples/train_detector.py`, on the CPU at the
smoke geometry.  The JAX script is not a package and reads `sys.argv`: it
is loaded from its file and driven through a monkeypatched `sys.argv`.

Tolerances, stated where they are used:
  * `train()`: every parameter leaf within `QAT_RTOL` (1e-5) relative L2
    of the reference's after 3 steps, as `test_torch_qat.py` holds
    `quick_qat`;
  * `main()`: per-chip mAP@0.5 within 0.02 for each design and column
    (the near-tie rule: a decision may flip where a float32 reordering
    moves a line current across its threshold), the same run-directory
    files, the same event kinds in order, and the same field names per
    event kind, except that the port's `mc_result` adds `enqueue_s` (as
    `test_torch_obs.py` holds for the layer CLI).  At 3 steps every mAP is
    0, so `main()` is also held at 20 steps, where they are not."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.examples import train_detector as ttd  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
QAT_RTOL = 1e-5
MAP_TOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this
    module's tests, the earlier settings restored after them."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def jtd():
    """The JAX package's `examples/train_detector.py`, loaded from its
    file."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_detector", ROOT / "examples" / "train_detector.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_ablation_columns_match(jtd):
    assert [n for n, _ in ttd.ABLATION] == [n for n, _ in jtd.ABLATION]
    for (_, t), (_, j) in zip(ttd.ABLATION, jtd.ABLATION):
        assert vars(t) == vars(j)


@pytest.mark.parametrize("train_chips", [1, 2])
def test_train_matches_reference(jtd, train_chips):
    """3 steps of the scripts' `train()` (warm-up and both decay points of
    the schedule), surrogate noise of every effect on, chips resampled
    every 2 steps: every leaf within QAT_RTOL of the reference's."""
    from repro.configs import yolo_irc as jcfg
    from repro.core import NonidealConfig as JNI
    from repro.data.detection import SyntheticDetectionData as JData
    from repro.models import IRCDetector as JDet
    jdet, det = JDet(jcfg.smoke("ternary")), IRCDetector(tcfg.smoke("ternary"))
    stride = 2 ** (len(det.cfg.stage_channels) + 1)
    geo = dict(img_hw=det.cfg.img_hw, stride=stride,
               n_classes=det.cfg.n_classes, n_anchors=det.cfg.n_anchors)
    common = dict(train_chips=train_chips, resample_every=2)
    jp = jtd.train(jdet, JData(**geo), 3, 2, 3e-3, noise_cfg=JNI.all(),
                   **common)
    tp = ttd.train(det, SyntheticDetectionData(**geo), 3, 2, 3e-3,
                   noise_cfg=NonidealConfig.all(), device="cpu", **common)
    want, got = _leaves(jax.device_get(jp)), _leaves(tp)
    assert [n for n, _ in got] == [n for n, _ in want]
    errs = {n: _rel_err(g.detach().numpy(), w)
            for (n, g), (_, w) in zip(got, want)}
    print(f"train_chips={train_chips}: max rel err {max(errs.values()):.1e} "
          f"({max(errs, key=errs.get)})")
    assert max(errs.values()) <= QAT_RTOL, errs


def _events(run):
    return [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]


def _fields(events):
    out = {}
    for e in events:
        out.setdefault(e["kind"], set()).update(e)
    return out


@pytest.mark.parametrize("steps", [3, 20])
def test_main_matches_reference(jtd, steps, tmp_path, monkeypatch, capsys):
    """Both scripts with the same arguments, both designs: per-chip mAPs
    per design and column within MAP_TOL, the same run-directory files,
    event kinds in order, field names per kind and summary keys, and the
    same printed Table II."""
    argv = ["--steps", str(steps), "--batch", "2", "--eval-batches", "1",
            "--mc-chips", "2"]
    monkeypatch.setattr(sys, "argv", ["train_detector.py"] + argv + [
        "--run-dir", str(tmp_path / "jax"), "--run-id", "r"])
    jtd.main()
    jout = capsys.readouterr().out
    report = ttd.main(argv + ["--device", "cpu", "--run-dir",
                              str(tmp_path / "port"), "--run-id", "r"])
    tout = capsys.readouterr().out
    jrun, trun = tmp_path / "jax" / "r", tmp_path / "port" / "r"
    assert report["run_dir"] == trun

    files = sorted(p.name for p in jrun.iterdir())
    assert sorted(p.name for p in trun.iterdir()) == files
    jev, tev = _events(jrun), _events(trun)
    assert [e["kind"] for e in tev] == [e["kind"] for e in jev]
    jf, tf = _fields(jev), _fields(tev)
    for kind in jf:
        extra = {"enqueue_s"} if kind == "mc_result" else set()
        assert tf[kind] == jf[kind] | extra, kind
    for j, t in zip(jev, tev):
        if j["kind"] == "train_step":
            assert (t["design"], t["step"]) == (j["design"], j["step"])
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)

    jman = json.loads((jrun / "manifest.json").read_text())
    tman = json.loads((trun / "manifest.json").read_text())
    assert tman["name"] == jman["name"] == "train-detector"
    assert tman["status"] == jman["status"] == "ok"
    assert set(tman["summary"]) == set(jman["summary"]) == {
        "drop_proposed", "drop_baseline"}

    nonzero = 0
    for name in files:
        if name.startswith("per_chip_"):
            j, t = np.load(jrun / name), np.load(trun / name)
            print(f"{name}: port {t.tolist()} JAX {j.tolist()}")
            np.testing.assert_allclose(t, j, atol=MAP_TOL, err_msg=name)
            nonzero += int(np.any(j > 0))
    assert nonzero > 0 or steps == 3

    def table(out):
        lines = out.splitlines()
        i = lines.index("=== Table II (synthetic-data analog, "
                        "population mean) ===")
        return lines[i:i + 4] + [ln for ln in lines
                                 if ln.startswith("mAP drop under")]
    print("\n".join(table(tout)))
    if all(np.array_equal(np.load(jrun / n), np.load(trun / n))
           for n in files if n.startswith("per_chip_")):
        assert table(tout) == table(jout)
