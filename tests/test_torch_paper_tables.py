"""The port's `repro_torch.examples.paper_tables` and `quickstart` against
the JAX package's `benchmarks/paper_tables.py` and `examples/quickstart.py`,
on the CPU.

Every row's `derived` field is parsed into its text and its numbers: the
text must be equal, integers equal, and each decimal within a tolerance,
stated here:
  * one unit of the reference's last printed digit (a value a few
    near-tie decisions away rounds to the neighbouring last digit), for
    every row but the detector's;
  * the detector's rows: MAP_TOL (0.02) on a mean or a std of per-chip
    mAP@0.5, twice that on a drop (the near-tie rule per chip; the port's
    smoke sweep takes K1's route where the reference takes its plain one,
    `test_torch_autotune.py`).
The reference samples its rows' device variation eagerly, and eager JAX
rounds the variation draw differently from jitted JAX, which the port
follows (ROADMAP, "Standing differences").  So the rows that sample
device variation (`VARIATION`) are held against the same reference
functions with `crossbar_forward` and `layer_current_stats` under
`jax.jit`; the test prints how far the eager rows are.

The detector rows train 40 QAT steps before they sweep.  From the same
init, the two packages' trajectories agree to float32 reordering for some
tens of steps and then part (a binary activation near its threshold flips
and moves the gradient; `test_torch_qat.py` holds 3 steps).  So the port's
detector rows sweep the checkpoints that the reference's `quick_qat`
trained, carried over by `params_from_jax`, in the same order.

The reference's `table2_ensemble_qat` writes its numbers into the repo's
`BENCH_mc.json`; here it runs with `benchmarks.mc_bench._merge_bench_json`
replaced by a no-op, and the file's bytes are held unchanged.

The quickstart: the weight fractions and the bias calibration's lines
must be equal to the reference's; each agreement percentage within 0.1
(one printed unit)."""
import dataclasses
import importlib.util
import math
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.examples import paper_tables as tpt  # noqa: E402
from repro_torch.examples import quickstart as tqs  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BENCH_MC = ROOT / "BENCH_mc.json"
NAMES = [f.__name__ for f in tpt.ALL]
VARIATION = ("fig14_wl_voltage", "table1_sensing", "table2_ablation_proxy",
             "table4_tolerance")
DETECTOR = ("table2_detector_map", "table2_ensemble_qat")
MAP_TOL = 0.02
NUMBER = re.compile(r"(-?\d+(?:\.\d+)?)")


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this
    module's tests, the earlier settings restored after them."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


def _jitted(fn):
    """`fn(key, x, mapped, **kw)` (the reference's `crossbar_forward` or
    `layer_current_stats`) under `jax.jit`, the planes passed as
    arguments; one compilation per mapped layer and keyword set."""
    cache = {}

    def call(key, x, mapped, **kw):
        ck = (id(mapped), tuple(sorted(kw.items())))
        if ck not in cache:
            def f(k, xx, gp, gn):
                return fn(k, xx, dataclasses.replace(mapped, g_pos=gp,
                                                     g_neg=gn), **kw)
            cache[ck] = (mapped, jax.jit(f))      # keeps `mapped` alive
        return cache[ck][1](key, x, mapped.g_pos, mapped.g_neg)
    return call


def _qat_call(det, steps, batch, kw):
    return (det.cfg.scheme, steps, batch, kw.get("train_chips", 1),
            kw.get("cfg_ni") is not None, kw.get("key") is not None)


@pytest.fixture(scope="module")
def rows():
    """(eager reference rows, jitted reference rows of `VARIATION`, port
    rows, BENCH_mc.json's bytes before), each by function name."""
    bench = BENCH_MC.read_bytes()
    trained = []
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        import benchmarks.mc_bench as mc_bench
        import repro.train.det_qat as jqat
        import repro_torch.train.det_qat as tqat
        from benchmarks import paper_tables as jpt
        mp.setattr(mc_bench, "_merge_bench_json", lambda *a, **k: None)
        reference_qat = jqat.quick_qat

        def record(det, data, steps, batch, **kw):
            params = reference_qat(det, data, steps, batch, **kw)
            trained.append((_qat_call(det, steps, batch, kw),
                            jax.device_get(params)))
            return params
        mp.setattr(jqat, "quick_qat", record)
        eager = {f.__name__: f() for f in jpt.ALL}
        mp.setattr(jpt, "crossbar_forward", _jitted(jpt.crossbar_forward))
        mp.setattr(jpt, "layer_current_stats",
                   _jitted(jpt.layer_current_stats))
        jitted = {name: getattr(jpt, name)() for name in VARIATION}

        replay = list(trained)

        def carried_over(det, data, steps, batch, **kw):
            call, params = replay.pop(0)
            assert _qat_call(det, steps, batch, kw) == call
            return params_from_jax(params, device=kw["device"])
        mp.setattr(tqat, "quick_qat", carried_over)
        port = {f.__name__: f(device="cpu") for f in tpt.ALL}
        assert not replay
    return eager, jitted, port, bench


def _split(derived):
    """(text pieces, number strings) of a derived field."""
    parts = NUMBER.split(derived)
    return parts[0::2], parts[1::2]


def _tol(want: str, text_before: str, name: str) -> float:
    if "." not in want:
        return 0.0
    if name in DETECTOR:
        return 2 * MAP_TOL if text_before.endswith("drop") else MAP_TOL
    return 10.0 ** -len(want.split(".")[1])


def _gap(got: str, want: str) -> float:
    """Largest |difference| of the numbers of two derived fields."""
    g, w = _split(got)[1], _split(want)[1]
    return max((abs(float(a) - float(b)) for a, b in zip(g, w)), default=0.0)


@pytest.mark.parametrize("name", NAMES)
def test_rows_match_reference(rows, name):
    eager, jitted, port, _ = rows
    want = jitted.get(name, eager[name])
    got = port[name]
    assert [r[0] for r in got] == [r[0] for r in want]
    for (row, us, derived), (_, _, ref), (_, _, ref_eager) in zip(
            got, want, eager[name]):
        assert math.isfinite(us) and us >= 0.0, row
        note = (f" (eager reference {ref_eager}, gap "
                f"{_gap(derived, ref_eager):.3g})" if name in jitted else "")
        print(f"{row}: port {derived} | reference {ref}{note}")
        texts, nums = _split(derived)
        want_texts, want_nums = _split(ref)
        assert texts == want_texts, (row, derived, ref)
        for i, (a, b) in enumerate(zip(nums, want_nums)):
            tol = _tol(b, want_texts[i], name)
            assert abs(float(a) - float(b)) <= tol + 1e-9, (row, derived, ref)


def test_bench_mc_json_untouched(rows):
    """Neither the twin nor the patched reference wrote BENCH_mc.json, and
    the twin's rows carry the numbers the reference would have written."""
    _, _, port, bench = rows
    assert BENCH_MC.read_bytes() == bench
    assert [r[0] for r in port["table2_ensemble_qat"]] == [
        "table2_qat_single", "table2_qat_ens4"]


def test_main_prints_the_csv(capsys):
    rows = tpt.main(["--only", "fig", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in out[1:]] == [r[0] for r in rows]
    assert [r[0] for r in rows][:2] == ["fig7_nonlinearity_ratio",
                                        "fig9_sa_required_diff"]
    assert len(rows) == 7


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    _load(ROOT / "examples" / "quickstart.py", "reference_quickstart").main()
    want = capsys.readouterr().out.replace("Pallas kernel", "kernel")
    got = tqs.main(["--device", "cpu"])
    out = capsys.readouterr().out
    print(out)
    want, out = want.splitlines(), out.splitlines()
    assert len(out) == len(want)
    for line, ref in zip(out, want):
        if line.startswith(("weight fractions", "bias calibration",
                            "  bias")):
            assert line == ref
            continue
        texts, nums = _split(line)
        want_texts, want_nums = _split(ref)
        assert texts == want_texts, (line, ref)
        for a, b in zip(nums, want_nums):
            assert abs(float(a) - float(b)) <= 0.1 + 1e-9, (line, ref)
    assert got["kernel_agreement"] >= 0.99
    assert got["bias"] in got["report"]
