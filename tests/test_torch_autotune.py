"""K1's row-tile autotuner (`repro_torch.kernels.autotune`) and the
detector's `use_kernel` / `--det-backend` routing, against the JAX
package's `repro.kernels.autotune` and routing, on the CPU.

The port's table is card-scoped (`cuda/<card slug>/...`) and an absent
entry routes to K1 at its default tile, where the reference keeps an
untuned problem on its plain path; on the CPU "K1" is its plain version.
So `use_kernel=None` here takes the kernel route in the port and the
plain route in the reference.  Bars, the reference's own: one route in
both packages agrees on >= 99% of head elements within 1e-4 (the two add
the digital stem and head in other orders, `test_torch_detector_mc.py`);
across routes the reference's `tests/test_kernel_detector.py` bar, >= 99%
of outputs equal, with the same 1e-4; per-chip mAP@0.5 within 0.02."""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.kernels import autotune, irc_mvm, ops  # noqa: E402
from repro_torch.mc import detector_mc as tmc  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_smoke_loader import chip_smoke  # noqa: E402

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"
H100_KEY = "cuda/nvidia-h100-80gb-hbm3"


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this
    module's tests, the earlier settings restored after them."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A tuning table under tmp_path in place of the committed one (which
    is never written); returns a writer of its entries."""
    path = tmp_path / "tuning.json"
    monkeypatch.setattr(autotune, "TUNING_JSON", path)
    autotune.load_table.cache_clear()

    def write(entries):
        path.write_text(json.dumps(entries))
        autotune.load_table.cache_clear()
        return path
    yield write
    autotune.load_table.cache_clear()


def _record(bm, tm, use_kernel, card=H100):
    return {"bm": bm, "tm": tm, "kernel_us": 100.0,
            "plain_us": 200.0 if use_kernel else 50.0,
            "use_kernel": use_kernel, "backend": autotune.backend_of("cpu")
            if card is None else f"cuda/{autotune.card_slug(card)}",
            "card": card}


# ---------------------------------------------------------------- the table

@pytest.mark.parametrize("which", ["smoke-ternary", "smoke-binary",
                                   "proposed", "baseline"])
@pytest.mark.parametrize("batch,chips", [(1, 4), (2, 4), (2, 8), (3, 1)])
def test_detector_problems_match_the_reference(which, batch, chips):
    from repro.configs import yolo_irc as jcfg
    from repro.kernels import autotune as jtune
    name, _, scheme = which.partition("-")
    cfgs = [getattr(m, name)(*((scheme,) if scheme else ()))
            for m in (tcfg, jcfg)]
    got = autotune.detector_problems(cfgs[0], batch, chips)
    assert got == jtune.detector_problems(cfgs[1], batch, chips)
    assert len(got) == len(cfgs[0].blocks_per_stage)


def test_problem_keys_are_card_scoped(table, monkeypatch):
    assert autotune.card_slug(H100) == "nvidia-h100-80gb-hbm3"
    assert autotune.card_slug(" NVIDIA H200 (141GB) ") == "nvidia-h200-141gb"
    assert autotune.backend_of("cpu") == "cpu"
    assert autotune.problem_key(4, 10, 60, 572, "cpu") == \
        "cpu/c4_m10_n60_k572"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: H100)
    autotune._cuda_backend.cache_clear()
    try:
        assert autotune.backend_of(torch.device("cuda", 0)) == H100_KEY
        assert autotune.problem_key(4, 10, 60, 572, H100_KEY) == \
            f"{H100_KEY}/c4_m10_n60_k572"
    finally:
        autotune._cuda_backend.cache_clear()
    if not torch.cuda.is_available():
        assert autotune.backend_of() == "cpu"
    # an entry measured on one card routes that card only
    table({f"{H100_KEY}/c4_m10_n60_k572": _record(64, 4, False)})
    assert not autotune.kernel_wins(4, 10, 60, 572, backend=H100_KEY)
    assert autotune.best_blocks(4, 10, 60, 572, backend=H100_KEY) == (64, 4)
    for other in ("cuda/nvidia-h200", "cpu"):
        assert autotune.kernel_wins(4, 10, 60, 572, backend=other)
        assert autotune.best_blocks(4, 10, 60, 572,
                                    backend=other) == autotune.DEFAULT_BLOCKS


def test_absent_entry_runs_k1_at_the_default_tile(table):
    table({})
    assert autotune.lookup(4, 10, 60, 572, "cpu") is None
    assert autotune.kernel_wins(4, 10, 60, 572, backend="cpu")
    assert autotune.best_blocks(4, 10, 60, 572, backend="cpu") == (32, 1)
    assert autotune.DEFAULT_BLOCKS == irc_mvm.DEFAULT_TILE == (32, 1)
    assert autotune.DEFAULT_CANDIDATES == irc_mvm.TILES
    assert (32, 1) in irc_mvm.TILES and len(irc_mvm.TILES) >= 2


def test_committed_winner_and_loser_round_trip(table):
    table({f"{H100_KEY}/c4_m512_n60_k556": _record(16, 1, True),
           f"{H100_KEY}/c4_m128_n60_k556": _record(64, 2, False)})
    assert autotune.kernel_wins(4, 512, 60, 556, backend=H100_KEY)
    assert autotune.best_blocks(4, 512, 60, 556, backend=H100_KEY) == (16, 1)
    assert not autotune.kernel_wins(4, 128, 60, 556, backend=H100_KEY)
    assert autotune.best_blocks(4, 128, 60, 556, backend=H100_KEY) == (64, 2)
    assert autotune.lookup(4, 512, 60, 556, H100_KEY)["plain_us"] == 200.0


def test_sweep_write_keeps_other_cards_entries(table, monkeypatch):
    other = "cuda/nvidia-h200/c4_m512_n60_k556"
    path = table({other: _record(32, 1, True, "NVIDIA H200"),
                  f"{H100_KEY}/c4_m512_n60_k556": _record(16, 1, True)})
    calls = []

    def fake(C, M, N, K, *, candidates):
        calls.append((C, M, N, K, tuple(candidates)))
        return dict(_record(64, 4, M == 512), card=H100,
                    backend=H100_KEY), []
    monkeypatch.setattr(autotune, "autotune_problem", fake)
    out = autotune.sweep([(4, 512, 60, 556), (4, 128, 60, 556)], write=True)
    assert calls == [(4, 512, 60, 556, irc_mvm.TILES),
                     (4, 128, 60, 556, irc_mvm.TILES)]
    assert set(out) == {f"{H100_KEY}/c4_m512_n60_k556",
                        f"{H100_KEY}/c4_m128_n60_k556"}
    written = json.loads(path.read_text())
    assert written[other] == _record(32, 1, True, "NVIDIA H200")
    assert written[f"{H100_KEY}/c4_m512_n60_k556"]["bm"] == 64
    # the cache was cleared: the dispatch reads the new entries
    assert autotune.best_blocks(4, 512, 60, 556, backend=H100_KEY) == (64, 4)
    assert not autotune.kernel_wins(4, 128, 60, 556, backend=H100_KEY)
    # another path: the table there only
    elsewhere = path.parent / "sub" / "t.json"
    autotune.sweep([(4, 128, 60, 556)], write=True, path=elsewhere)
    assert set(json.loads(elsewhere.read_text())) == {
        f"{H100_KEY}/c4_m128_n60_k556"}
    assert json.loads(path.read_text()) == written


def test_autotune_problem_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_problem(4, 64, 60, 572)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.main(["--chips", "2", "--batch", "1"])


def test_committed_table_parses_with_candidate_tiles():
    path = Path(autotune.__file__).resolve().parent / "tuning.json"
    assert autotune.TUNING_JSON == path
    entries = json.loads(path.read_text())
    for key, rec in entries.items():
        backend, _, problem = key.rpartition("/")
        assert backend == rec["backend"] == \
            f"cuda/{autotune.card_slug(rec['card'])}", key
        C, M, N, K = (int(p[1:]) for p in problem.split("_"))
        assert key == autotune.problem_key(C, M, N, K, backend)
        assert (rec["bm"], rec["tm"]) in irc_mvm.TILES, key
        assert set(rec["candidates_us"]) == {f"{b}x{t}"
                                             for b, t in irc_mvm.TILES}
        assert rec["kernel_us"] == min(rec["candidates_us"].values())
        assert rec["use_kernel"] == (rec["kernel_us"] < rec["plain_us"])


def test_committed_entries_name_tiles_and_none_takes_the_table_tile(
        table, monkeypatch):
    """Every committed entry names a tile K1 has; a launch that names no
    tile runs at the table's tile for its problem on its card (the
    default where the table has none), an explicit tile as given."""
    committed = Path(autotune.__file__).resolve().parent / "tuning.json"
    for key, rec in json.loads(committed.read_text()).items():
        assert (rec["bm"], rec["tm"]) in irc_mvm.TILES, key
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(autotune, "backend_of", lambda d=None: H100_KEY)
    other = next(t for t in irc_mvm.TILES if t != irc_mvm.DEFAULT_TILE)
    table({f"{H100_KEY}/c4096_m256_n60_k572": _record(*other, True)})
    assert ops.k1_tile(dev, 4096, 256, 60, 572) == other
    assert ops.k1_tile(dev, 4, 256, 60, 572) == irc_mvm.DEFAULT_TILE
    assert ops.k1_tile(dev, 4096, 256, 60, 572,
                       irc_mvm.DEFAULT_TILE) == irc_mvm.DEFAULT_TILE
    with pytest.raises(ValueError, match="no tile"):
        ops.k1_tile(dev, 4096, 256, 60, 572, (48, 3))
    assert autotune.layer_problems(60, 572, 256, 4096) == [
        (4096, 256, 60, 572)]


def test_unknown_tile_raises_everywhere():
    from repro_torch.core.macro import DEFAULT_MACRO
    from repro_torch.kernels.ref import IrcEpilogueParams
    g = torch.Generator().manual_seed(0)
    C, B, R, N = 2, 5, 40, 3
    x = (torch.rand((B, R), generator=g) < 0.5).float()
    ep, en = torch.rand((2, C, R, N), generator=g)
    gp = (torch.rand((R, N), generator=g) < 0.5).float()
    eps = torch.randn((C, B, N), generator=g)
    rnd = torch.zeros((C, B, N))
    params = IrcEpilogueParams.from_macro(DEFAULT_MACRO)
    want = ops.irc_mvm_chips(x, ep, en, gp, 1 - gp, eps, rnd, params)
    for tile in irc_mvm.TILES:
        assert torch.equal(ops.irc_mvm_chips(x, ep, en, gp, 1 - gp, eps, rnd,
                                             params, tile=tile), want)
    for bad in ((48, 3), (64, 1), (32, 4), (0, 0)):
        with pytest.raises(ValueError, match="no tile"):
            ops.irc_mvm_chips(x, ep, en, gp, 1 - gp, eps, rnd, params,
                              tile=bad)
        with pytest.raises(ValueError, match="no tile"):
            irc_mvm.launch_chips(x, ep, en, gp, 1 - gp, eps, rnd,
                                 torch.empty((C, B, N)), params, tile=bad)


# ------------------------------------------------------------------ routing

@pytest.fixture(scope="module")
def smoke_pair():
    """The reference detector at the smoke geometry (init + calibrate_bn,
    as its kernel tests build it), its params carried into the port, two
    images and the same 2-chip ensemble on both sides."""
    from repro.configs import yolo_irc as jcfg
    from repro.core import NonidealConfig as JNI
    from repro.mc import build_detector_ensemble as jbuild
    from repro.models import IRCDetector as JDet
    jdet = JDet(jcfg.smoke("ternary"))
    jp = jdet.init(jax.random.PRNGKey(0))
    jp = jdet.calibrate_bn(jp, jax.random.uniform(jax.random.PRNGKey(1),
                                                  (4, 32, 32, 3)))
    imgs = np.array(jax.random.uniform(jax.random.PRNGKey(2),
                                       (2, 32, 32, 3)))
    jens = jax.jit(lambda k, p: jbuild(k, jdet, p, 2, cfg=JNI.all()))(
        jax.random.PRNGKey(3), jp)
    det = IRCDetector(tcfg.smoke())
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    tens = tmc.build_detector_ensemble(prng.PRNGKey(3, device="cpu"), det,
                                       tp, 2, cfg=NonidealConfig.all())
    return jdet, jp, jens, det, tp, tens, imgs


def _jax_apply(smoke_pair, use_kernel, **kw):
    from repro.core import NonidealConfig as JNI
    jdet, jp, jens, _, _, _, imgs = smoke_pair
    return np.asarray(jdet.apply(jp, jnp.asarray(imgs), mode="ensemble",
                                 ensemble=jens, cfg_ni=JNI.all(),
                                 use_kernel=use_kernel, **kw))


def _port_apply(smoke_pair, use_kernel, **kw):
    _, _, _, det, tp, tens, imgs = smoke_pair
    return det.apply(tp, torch.from_numpy(imgs), mode="ensemble",
                     ensemble=tens, cfg_ni=NonidealConfig.all(),
                     use_kernel=use_kernel, **kw).numpy()


def _close(a, b):
    return float(np.mean(np.abs(a - b) <= 1e-4))


@pytest.mark.parametrize("use_kernel", [True, False, None])
def test_apply_routes_match_the_reference(smoke_pair, use_kernel, table):
    table({})
    # the reference's forced kernel through its oracle, which its own tests
    # hold bit-exact to the Pallas route
    kw = {"kernel_impl": "ref"} if use_kernel else {}
    want = _jax_apply(smoke_pair, use_kernel, **kw)
    got = _port_apply(smoke_pair, use_kernel)
    assert got.shape == want.shape == (2, 2) + smoke_pair[3].head_geometry()
    frac = _close(got, want)
    print(f"use_kernel={use_kernel}: {frac:.6f} within 1e-4, "
          f"{float(np.mean(got == want)):.6f} equal")
    assert frac >= 0.99
    if use_kernel is None:
        # an untuned problem: the port's kernel route, bit for bit
        np.testing.assert_array_equal(got, _port_apply(smoke_pair, True))


def test_apply_follows_the_table(smoke_pair, table):
    """Entries for the CPU backend route the port as they say: the plain
    route where the plain version won, the kernel at its tile elsewhere."""
    det = smoke_pair[3]
    cfg = det.cfg
    K = cfg.bias_rows + 9 * cfg.group
    probs = autotune.detector_problems(cfg, 2, 2)
    assert [p[1] for p in probs] == [128, 512] and probs[0][3] == K
    table({autotune.problem_key(*p, "cpu"): _record(64, 4, False, None)
           for p in probs})
    np.testing.assert_array_equal(_port_apply(smoke_pair, None),
                                  _port_apply(smoke_pair, False))
    seen = []
    orig = ops.irc_mvm_chips

    def spy(*a, tile=None, **kw):
        seen.append(tile)
        return orig(*a, tile=tile, **kw)
    table({autotune.problem_key(*p, "cpu"): _record(64, 2, True, None)
           for p in probs})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "irc_mvm_chips", spy)
        got = _port_apply(smoke_pair, None)
    assert seen == [(64, 2)] * 3        # s0b0 1 group, s1b0 2 groups
    np.testing.assert_array_equal(got, _port_apply(smoke_pair, True))


def test_forced_kernel_with_partial_sums_raises():
    from repro.configs import yolo_irc as jcfg
    det = IRCDetector(tcfg.smoke("binary"))
    assert det.cfg.accumulation == jcfg.smoke("binary").accumulation \
        == "partial_sum"
    with pytest.raises(ValueError, match="requires single_shot"):
        det._gconv_ensemble((), torch.zeros((1, 4, 4, 60)), 60, 60,
                            cfg_ni=NonidealConfig.all(), use_kernel=True)


def _own_periphery_models():
    """The same device model on both sides: the analytic variation, but
    its own SA-offset sigma (0.75 g(p)), so its periphery is not the
    analytic one the kernel's epilogue bakes in."""
    import dataclasses
    from repro.device.analytic import AnalyticDeviceModel as JAnalytic
    from repro_torch.core import nonideal as tni
    from repro_torch.device.analytic import AnalyticDeviceModel

    @dataclasses.dataclass(frozen=True)
    class JOwn(JAnalytic):
        name = "own-periphery"

        @property
        def analytic_periphery(self):
            return False

        def sa_offset_sigma(self, p, spec=None, extra_units=0.0):
            from repro.core import nonideal as jni
            from repro.core.macro import DEFAULT_MACRO
            return 0.75 * (jni.sa_required_diff(p, spec or DEFAULT_MACRO)
                           + extra_units)

    @dataclasses.dataclass(frozen=True)
    class Own(AnalyticDeviceModel):
        name = "own-periphery"

        @property
        def analytic_periphery(self):
            return False

        def sa_offset_sigma(self, p, spec=None, extra_units=0.0):
            from repro_torch.core.macro import DEFAULT_MACRO
            return 0.75 * (tni.sa_required_diff(p, spec or DEFAULT_MACRO)
                           + extra_units)
    return JOwn(), Own()


def test_own_periphery_takes_the_plain_route(smoke_pair):
    """Repaired: under `use_kernel=None` a device model with its own
    periphery takes the plain route, as the reference's auto does (it
    raised before); forcing the kernel raises the reference's error."""
    jdev, dev = _own_periphery_models()
    want = _jax_apply(smoke_pair, None, device=jdev)
    got = _port_apply(smoke_pair, None, device=dev)
    frac = _close(got, want)
    print(f"own periphery: {frac:.6f} within 1e-4")
    assert frac >= 0.99
    np.testing.assert_array_equal(got, _port_apply(smoke_pair, False,
                                                   device=dev))
    # its own sigma reaches the outputs
    assert not np.array_equal(got, _port_apply(smoke_pair, None))
    msg = ("has a non-analytic periphery; the chip-batched kernel supports "
           "analytic-periphery backends only")
    with pytest.raises(NotImplementedError, match=msg):
        _port_apply(smoke_pair, True, device=dev)
    with pytest.raises(NotImplementedError, match=msg):
        _jax_apply(smoke_pair, True, device=jdev, kernel_impl="ref")


# --------------------------------------------------------------------- CLIs

@pytest.mark.parametrize("port,ref", [("plain", "jnp"), ("kernel", "kernel")])
def test_mc_cli_det_backend_matches_the_jax_cli(port, ref, tmp_path,
                                                monkeypatch, capsys, table):
    from repro.launch import mc as jcli
    from repro_torch.launch import mc as tcli
    table({})
    common = ["--network", "detector", "--chips", "2", "--chunk", "2",
              "--ablation", "all", "--seed", "1"]
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr(sys, "argv", ["mc"] + common + [
        "--det-backend", ref, "--run-dir", "", "--json", str(jout)])
    jcli.main()
    tcli.main(common + ["--det-backend", port, "--device", "cpu", "--json",
                        str(tout), "--run-dir", str(tmp_path), "--run-id",
                        "r"])
    out = capsys.readouterr().out
    assert f"backend={ref} " in out and f"backend={port} " in out
    man = json.loads((tmp_path / "r" / "manifest.json").read_text())
    assert man["args"]["det_backend"] == port
    want = json.loads(jout.read_text())["results"]["init"]
    got = json.loads(tout.read_text())["results"]["init"]
    assert list(got) == list(want) == ["ideal", "all"]
    for name in want:
        np.testing.assert_allclose(got[name]["per_chip_map50"],
                                   want[name]["per_chip_map50"], atol=0.02,
                                   err_msg=name)


def test_layer_cli_refuses_det_backend():
    """The layer network refuses every non-default `--det-backend`, the
    JAX CLI's `jnp` and its alias `plain` among them."""
    from repro_torch.launch import mc as cli
    for backend in ("jnp", "plain", "kernel"):
        with pytest.raises(SystemExit, match="does not take --det-backend"):
            cli.main(["--network", "layer", "--det-backend", backend,
                      "--device", "cpu"])


def _per_chip(report):
    return {ck: {col: r["per_chip_map50"] for col, r in cols.items()}
            for ck, cols in report["results"].items()}


def test_jnp_is_the_plain_route_on_both_clis(tmp_path, capsys):
    """`--det-backend jnp` (the JAX CLIs' name) takes the plain batched
    route on both port CLIs: the mc CLI's per-chip mAPs and the serve
    CLI's responses equal those of `--det-backend plain` (CPU, smoke
    geometry)."""
    from repro_torch.launch import mc as mcli
    from repro_torch.launch import serve as scli
    assert mcli.DET_BACKENDS["jnp"] is mcli.DET_BACKENDS["plain"] is False
    common = ["--network", "detector", "--chips", "2", "--chunk", "2",
              "--ablation", "all", "--seed", "1", "--device", "cpu",
              "--run-dir", ""]
    maps = {}
    for backend in ("jnp", "plain"):
        out = tmp_path / f"{backend}.json"
        mcli.main(common + ["--det-backend", backend, "--json", str(out)])
        maps[backend] = _per_chip(json.loads(out.read_text()))
    assert maps["jnp"] == maps["plain"]
    assert "backend=jnp " in capsys.readouterr().out
    served = {}
    for backend in ("jnp", "plain"):
        scli.main(["--network", "detector", "--device", "cpu", "--requests",
                   "2", "--slots", "2", "--committee", "2", "--det-backend",
                   backend, "--run-dir", str(tmp_path), "--run-id", backend])
        man = json.loads((tmp_path / backend / "manifest.json").read_text())
        assert man["status"] == "ok" and man["args"]["det_backend"] == backend
        # each request's boxes and committee confidence, without its wave
        # and queue time, which follow the scheduler's timing
        served[backend] = [
            re.sub(r" \(wave \d+\)|, queue \d+ms", "", line)
            for line in capsys.readouterr().out.splitlines()
            if line.startswith("req ")]
    assert len(served["jnp"]) == 2
    assert served["jnp"] == served["plain"]


def test_serve_cli_det_backend(tmp_path, capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--network", "detector", "--device", "cpu", "--requests", "2",
              "--slots", "2", "--committee", "2", "--det-backend", "plain",
              "--run-dir", str(tmp_path), "--run-id", "s"])
    man = json.loads((tmp_path / "s" / "manifest.json").read_text())
    assert man["status"] == "ok" and man["args"]["det_backend"] == "plain"
    assert "2 requests over 2-chip committees" in capsys.readouterr().out


# ------------------------------------------------- chip_smoke's host helpers

def test_smoke_tuning_prefix():
    smoke = chip_smoke()
    assert smoke.tuning_prefix(H100) == H100_KEY + "/"
    assert smoke.tuning_prefix("NVIDIA H100 PCIe") == "cuda/nvidia-h100-pcie/"


def test_smoke_autotune_verdicts():
    smoke = chip_smoke()
    k = [f"{H100_KEY}/c4_m{m}_n60_k572" for m in (1, 2, 3, 4)]
    measured = {k[0]: _record(32, 2, True), k[1]: _record(64, 4, True),
                k[2]: _record(16, 1, False), k[3]: _record(32, 1, True)}
    committed = {k[0]: _record(32, 2, True), k[1]: _record(16, 1, True),
                 k[2]: _record(16, 1, True),
                 "cuda/other/c4_m4_n60_k572": _record(32, 1, True)}
    assert smoke.autotune_verdicts(measured, committed) == [
        (k[0], (32, 2, True), (32, 2, True), "agrees"),
        (k[1], (64, 4, True), (16, 1, True), "same route"),
        (k[2], (16, 1, False), (16, 1, True), "differs"),
        (k[3], (32, 1, True), None, "absent")]


def test_smoke_ptxas_spill_rule():
    smoke = chip_smoke()
    log = ("ptxas info    : Function properties for k1\n"
           "    2304 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n")
    assert smoke.ptxas_spills(log, stack=True) == []
    assert len(smoke.ptxas_spills(log)) == 1
    spill = "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads"
    assert smoke.ptxas_spills(spill, stack=True) == [spill.strip()]
