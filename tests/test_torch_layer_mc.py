"""Layer-level chip-population MC of the port against the JAX package, for
the proposed design (ternary, single-shot, bias rows) and the baseline
(binary weights against one shared reference line, partial sums).

Same numpy inputs and the same PRNG keys on both sides.  Planes agree bit
for bit (the normals and the exp follow XLA's float32 code);
analog differences within 1e-4 (a few float32 ulps of the line currents);
partial-sum accumulation within 1e-5 relative; SA decisions and per-chip bit agreement
are equal except at near-ties, decisions whose margin in the port is below
`NEAR_TIE_TOL`, which are counted.  The ideal column is full of exact ties
(x.w = 0 gives i+ = i- in real arithmetic, the HRS leak included), so its
bits are set by float32 rounding order on both sides."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import calibration as jcal  # noqa: E402
from repro.core import crossbar as jcb  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import nonideal as jni  # noqa: E402
from repro.mc import engine as jeng  # noqa: E402
from repro.mc import ensemble as jens  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import calibration as tcal  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core.macro import DEFAULT_MACRO  # noqa: E402
from repro_torch.core.mapping import extend_rows  # noqa: E402
from repro_torch.kernels.ref import NEAR_TIE_TOL  # noqa: E402
from repro_torch.mc import engine as teng  # noqa: E402
from repro_torch.mc import ensemble as tens  # noqa: E402

torch.set_num_threads(2)

FAN_IN, N_OUT, BATCH = 128, 32, 32
# design -> (scheme, bias rows, accumulation, partial rows): partial rows of
# 64 split the baseline's 128-row column into two chunks
DESIGNS = {"proposed": ("ternary", 8, "single_shot", 256),
           "baseline": ("binary", 0, "partial_sum", 64)}


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_scheme(request):
    """Tests that feed the same key to both sides run once per threefry
    scheme, both packages set to it (the original scheme is jax 0.4.x's
    default)."""
    with jax.threefry_partitionable(request.param), \
            prng.threefry_partitionable(request.param):
        yield request.param


def _rng(seed):
    return np.random.default_rng(seed)


def _layer(design, seed=0, density=0.5, bias_rows=None, fan_in=FAN_IN):
    """(JAX mapped layer, port mapped layer, x bits) from numpy weights."""
    scheme, design_rows = DESIGNS[design][:2]
    bias_rows = design_rows if bias_rows is None else bias_rows
    batch = BATCH
    rng = _rng(seed)
    w = rng.standard_normal((fan_in, N_OUT)).astype(np.float32)
    x = (rng.random((batch, fan_in)) < density).astype(np.float32)
    if scheme == "ternary":
        from repro.core.ternary import ternary_quantize
        wq = np.asarray(ternary_quantize(jnp.asarray(w)))
        jm = jmap.ternary_planes(jnp.asarray(wq), bias_rows=bias_rows)
        tm = tmap.ternary_planes(torch.from_numpy(wq), bias_rows=bias_rows)
    else:
        wq = np.where(w >= 0, 1.0, -1.0).astype(np.float32)
        jm = jmap.binary_planes(jnp.asarray(wq))
        tm = tmap.binary_planes(torch.from_numpy(wq))
    return jm, tm, x


def _jcfg(cfg):
    return jni.NonidealConfig(**dataclasses.asdict(cfg))


def _jsample(key, jm, n_chips, cfg):
    """The reference's `sample_ensemble` jitted, as its sweeps run it (XLA
    folds the variation sigma into the normal's sqrt(2) there)."""
    return jax.jit(lambda k: jens.sample_ensemble(k, jm, n_chips,
                                                  cfg=cfg))(key)


@pytest.mark.parametrize("with_bn", [False, True])
def test_binary_planes_match(with_bn):
    rng = _rng(1)
    w = np.where(rng.standard_normal((540, 60)) >= 0, 1.0, -1.0).astype(
        np.float32)
    units = None
    if with_bn:
        units = (rng.standard_normal(60) * 60).astype(np.float32)
        units[:4] = [2.5, -3.5, 200.0, -150.0]      # half-even, clipping
    jm = jmap.binary_planes(jnp.asarray(w), None if units is None
                            else jnp.asarray(units))
    tm = tmap.binary_planes(torch.from_numpy(w), None if units is None
                            else torch.from_numpy(units))
    np.testing.assert_array_equal(np.asarray(jm.g_pos), tm.g_pos.numpy())
    np.testing.assert_array_equal(np.asarray(jm.g_neg), tm.g_neg.numpy())
    assert (tm.rows, tm.fan_in, tm.bias_rows, tm.scheme) == (
        jm.rows, jm.fan_in, jm.bias_rows, "binary")
    assert tm.bias_rows == (DEFAULT_MACRO.bn_rows if with_bn else 0)


def test_binary_sample_chip_planes_match(threefry_scheme):
    """The baseline's one reference line: a [rows, 1] mask from the same
    split key, common to every column, single key or a batch of them."""
    jm, tm, _ = _layer("baseline")
    cfg = tni.NonidealConfig.all()
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    tkey = prng.fold_in(prng.PRNGKey(3, device="cpu"), 7)
    jep, jen, _ = jax.jit(lambda k: jcb.sample_chip_planes(
        k, jm.g_pos, jm.g_neg, "binary", _jcfg(cfg)))(key)
    tep, ten, _ = tcb.sample_chip_planes(tkey, tm.g_pos, tm.g_neg, "binary",
                                         cfg)
    np.testing.assert_array_equal(tep.numpy(), np.asarray(jep))
    np.testing.assert_array_equal(ten.numpy(), np.asarray(jen))
    assert torch.all(ten == ten[:, :1])               # common to every column
    ids = jnp.arange(3, dtype=jnp.uint32)
    jk = jax.vmap(lambda i: jax.random.fold_in(key, i))(ids)
    jb = jax.jit(jax.vmap(lambda k: jcb.sample_chip_planes(
        k, jm.g_pos, jm.g_neg, "binary", _jcfg(cfg))[1]))(jk)
    tb = tcb.sample_chip_planes(prng.fold_in(tkey, torch.arange(3)),
                                tm.g_pos, tm.g_neg, "binary", cfg)[1]
    assert tb.shape == (3, FAN_IN, N_OUT)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("partial_rows", [256, 100, 64])
@pytest.mark.parametrize("effects", ["all", "none"])
def test_partial_sum_accumulate_matches(partial_rows, effects):
    rng = _rng(partial_rows)
    blocks = (rng.random((6, 17, 20)) * 20).astype(np.float32)
    counts = rng.integers(0, 33, size=(6, 17, 20)).astype(np.float32)
    cfg = (tni.NonidealConfig.all() if effects == "all"
           else tni.NonidealConfig.none())
    ji, jp = jcb._accumulate(jnp.asarray(blocks), jnp.asarray(counts),
                             _jcfg(cfg), jcb.DEFAULT_MACRO, "partial_sum",
                             partial_rows)
    ti, tp = tcb._accumulate(torch.from_numpy(blocks),
                             torch.from_numpy(counts), cfg, DEFAULT_MACRO,
                             "partial_sum", partial_rows)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("scale", [4.0, 12.0, 30.0, 80.0])
def test_calibrate_bias_matches(scale):
    """The chosen bias equals the reference's; when the two best totals
    lie within 1e-6 of each other the margin is printed."""
    rng = _rng(int(scale))
    i_pos = (rng.random(2000) * scale).astype(np.float32)
    i_neg = (rng.random(2000) * scale).astype(np.float32)
    p = np.round(rng.random(2000) * 3 * scale).astype(np.float32)
    jb, jrep = jcal.calibrate_bias(jnp.asarray(i_pos), jnp.asarray(i_neg),
                                   jnp.asarray(p))
    tb, trep = tcal.calibrate_bias(torch.from_numpy(i_pos),
                                   torch.from_numpy(i_neg),
                                   torch.from_numpy(p))
    totals = sorted(r["total"] for r in trep.values())
    print(f"scale {scale}: bias {tb}, margin to the runner-up "
          f"{totals[1] - totals[0]:.3g}")
    assert tb == jb and set(trep) == set(jrep)
    for b, rates in trep.items():
        for k, v in rates.items():
            assert v == pytest.approx(jrep[b][k], rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("fan_in,density", [(128, 0.3), (256, 0.3),
                                            (256, 0.6)])
def test_calibrate_ensemble_bias_matches(threefry_scheme, fan_in, density):
    """Per-die bias counts equal the reference's, including layers where
    the dies choose different counts."""
    jm, tm, x = _layer("proposed", seed=5, density=density, bias_rows=32,
                       fan_in=fan_in)
    key = jax.random.PRNGKey(4)
    jc = jens.calibrate_ensemble_bias(
        _jsample(key, jm, 8, jni.NonidealConfig.all()), jnp.asarray(x))
    tc = tens.calibrate_ensemble_bias(
        tens.sample_ensemble(prng.PRNGKey(4, device="cpu"), tm, 8,
                             cfg=tni.NonidealConfig.all()),
        torch.from_numpy(x))
    print(f"fan_in {fan_in}, density {density}: bias units "
          f"{tc.bias_units.tolist()}")
    np.testing.assert_array_equal(tc.bias_units.numpy(),
                                  np.asarray(jc.bias_units))
    assert tc.planes_per_chip() and tc.gp.shape == (8, 32 + fan_in, N_OUT)
    np.testing.assert_array_equal(tc.gp.numpy(), np.asarray(jc.gp))
    np.testing.assert_array_equal(tc.gn.numpy(), np.asarray(jc.gn))
    np.testing.assert_array_equal(tc.ep.numpy(), np.asarray(jc.ep))


def _sa_margin(ens, x, cfg, accumulation, partial_rows):
    """The port's decision margin of every SA output [chips, B, N]:
    |i+ - i- + offset|, and with the sensing range on the line currents'
    distance from the window's edges."""
    kw = dict(cfg=cfg, accumulation=accumulation, partial_rows=partial_rows,
              output="diff")
    zeros = torch.zeros_like(ens.ep)
    i_pos = teng.ensemble_apply(dataclasses.replace(ens, en=zeros), x, **kw)
    i_neg = -teng.ensemble_apply(dataclasses.replace(ens, ep=zeros), x, **kw)
    margin = i_pos - i_neg
    if cfg.sa_variation:
        x_ext = extend_rows(x, ens.lead_rows)
        p = x_ext @ (ens.gp + ens.gn)
        eps, _ = teng.periphery_noise(ens.sa_keys, x.shape[-2], ens.n_out)
        margin = margin + 0.5 * tni.sa_required_diff(p) * eps
    margin = margin.abs()
    if cfg.sensing_range:
        lo, hi = torch.minimum(i_pos, i_neg), torch.maximum(i_pos, i_neg)
        margin = torch.minimum(margin, torch.minimum(
            (lo - DEFAULT_MACRO.sense_low_units).abs(),
            (hi - DEFAULT_MACRO.sense_high_units).abs()))
    return margin


def _near_ties(a, b, margin):
    """(differing outputs per chip, whether every one is a near-tie)."""
    mism = torch.as_tensor(a) != torch.as_tensor(b)
    return (mism.sum(dim=(-2, -1)).numpy(),
            bool((margin[mism] < NEAR_TIE_TOL).all()))


@pytest.mark.parametrize("output", ["binary", "diff"])
@pytest.mark.parametrize("design", list(DESIGNS))
def test_ensemble_apply_matches_reference(threefry_scheme, design, output):
    _, _, acc, prows = DESIGNS[design]
    jm, tm, x = _layer(design, seed=2)
    cfg = tni.NonidealConfig.all()
    jens_ = _jsample(jax.random.PRNGKey(6), jm, 4, _jcfg(cfg))
    tens_ = tens.sample_ensemble(prng.PRNGKey(6, device="cpu"), tm, 4,
                                 cfg=cfg)
    j = np.asarray(jeng.ensemble_apply(jens_, jnp.asarray(x), cfg=_jcfg(cfg),
                                       accumulation=acc, partial_rows=prows,
                                       output=output))
    t = teng.ensemble_apply(tens_, torch.from_numpy(x), cfg=cfg,
                            accumulation=acc, partial_rows=prows,
                            output=output)
    assert t.shape == j.shape == (4, BATCH, N_OUT)
    if output == "diff":
        # line currents reach ~60 units here (ulp 7.6e-6) and the two sides
        # sum blocks and chips in other float32 orders: a few ulps apart
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-4)
        return
    n, ok = _near_ties(t, j, _sa_margin(tens_, torch.from_numpy(x), cfg,
                                         acc, prows))
    print(f"{design}: near-tie SA flips per chip {n.tolist()}")
    assert ok


@pytest.mark.parametrize("design", list(DESIGNS))
def test_ensemble_apply_per_chip_inputs_match_reference(threefry_scheme,
                                                        design):
    """Chip-diverged word lines [chips, B, fan_in] (`per_chip_x`), as a
    network feeds them to the layers after its first."""
    _, _, acc, prows = DESIGNS[design]
    jm, tm, _ = _layer(design, seed=9)
    x = (_rng(10).random((3, BATCH, FAN_IN)) < 0.5).astype(np.float32)
    cfg = tni.NonidealConfig.all()
    jens_ = _jsample(jax.random.PRNGKey(7), jm, 3, _jcfg(cfg))
    tens_ = tens.sample_ensemble(prng.PRNGKey(7, device="cpu"), tm, 3,
                                 cfg=cfg)
    kw = dict(accumulation=acc, partial_rows=prows, per_chip_x=True)
    j = np.asarray(jeng.ensemble_apply(jens_, jnp.asarray(x), cfg=_jcfg(cfg),
                                       **kw))
    t = teng.ensemble_apply(tens_, torch.from_numpy(x), cfg=cfg, **kw)
    n, ok = _near_ties(t, j, _sa_margin(tens_, torch.from_numpy(x), cfg,
                                         acc, prows))
    print(f"{design}, per-chip word lines: near-tie flips {n.tolist()}")
    assert t.shape == (3, BATCH, N_OUT) and ok


@pytest.mark.parametrize("design", list(DESIGNS))
def test_run_ablation_matches_reference(threefry_scheme, design):
    """Table II at the same chip ids: per-chip bit agreement equal to the
    reference's up to the chip's near-tie decisions."""
    scheme, _, acc, prows = DESIGNS[design]
    jm, tm, x = _layer(design, seed=3)
    ref = (x @ _weights(tm) > 0).astype(np.float32)
    jres = jeng.run_ablation(
        jax.random.PRNGKey(8), jm, jnp.asarray(x), ref_bits=jnp.asarray(ref),
        mc=jeng.McConfig(n_chips=6, chunk_size=4, accumulation=acc,
                         partial_rows=prows))
    tres = teng.run_ablation(
        prng.PRNGKey(8, device="cpu"), tm, torch.from_numpy(x),
        ref_bits=torch.from_numpy(ref),
        mc=teng.McConfig(n_chips=6, chunk_size=4, accumulation=acc,
                         partial_rows=prows))
    assert list(tres) == [name for name, _ in teng.TABLE2_ABLATION]
    for (name, cfg), tr in zip(teng.TABLE2_ABLATION, tres.values()):
        ens = tens.sample_ensemble(prng.PRNGKey(8, device="cpu"), tm, 6,
                                   cfg=cfg)
        margin = _sa_margin(ens, torch.from_numpy(x), cfg, acc, prows)
        ties = (margin < NEAR_TIE_TOL).sum(dim=(-2, -1)).numpy()
        for metric in ("bit_agreement", "ones_fraction"):
            gap = np.abs(tr.per_chip[metric]
                         - jres[name].per_chip[metric]) * BATCH * N_OUT
            print(f"{design} {name} {metric}: outputs apart per chip "
                  f"{np.round(gap).tolist()}, near-ties {ties.tolist()}")
            assert np.all(np.round(gap) <= ties)
        assert tr.n_chips == 6 and tr.bias_units is None


def _weights(tm):
    """The signed weights behind a port mapping (no lead rows here)."""
    if tm.scheme == "binary":
        return (2.0 * tm.g_pos - 1.0).numpy()
    return (tm.g_pos - tm.g_neg).numpy()[tm.rows - tm.fan_in:]


def test_calibrated_run_matches_reference(threefry_scheme):
    jm, tm, x = _layer("proposed", seed=4, density=0.2)
    mc_kw = dict(n_chips=5, chunk_size=3, calibrate=True,
                 cfg=tni.NonidealConfig.all())
    ref = (x @ _weights(tm) > 0).astype(np.float32)
    jr = jeng.run_mc(jax.random.PRNGKey(2), jm, jnp.asarray(x),
                     ref_bits=jnp.asarray(ref),
                     mc=jeng.McConfig(**dict(mc_kw, cfg=jni.NonidealConfig.all())))
    tr = teng.run_mc(prng.PRNGKey(2, device="cpu"), tm, torch.from_numpy(x),
                     ref_bits=torch.from_numpy(ref), mc=teng.McConfig(**mc_kw))
    print(f"calibrated bias units {tr.bias_units.tolist()}")
    np.testing.assert_array_equal(tr.bias_units, jr.bias_units)
    np.testing.assert_array_equal(tr.per_chip["bit_agreement"],
                                  jr.per_chip["bit_agreement"])


@pytest.mark.parametrize("design", list(DESIGNS))
def test_chunking_is_invisible(design):
    _, _, acc, prows = DESIGNS[design]
    _, tm, x = _layer(design, seed=6)
    x = torch.from_numpy(x)
    ref = torch.from_numpy((x.numpy() @ _weights(tm) > 0).astype(np.float32))
    runs = [teng.run_mc(prng.PRNGKey(1, device="cpu"), tm, x, ref_bits=ref,
                        mc=teng.McConfig(n_chips=7, chunk_size=c,
                                         accumulation=acc,
                                         partial_rows=prows))
            for c in (2, 3)]
    for metric in ("bit_agreement", "ones_fraction"):
        np.testing.assert_array_equal(runs[0].per_chip[metric],
                                      runs[1].per_chip[metric])
    assert runs[0].n_chips == runs[1].n_chips == 7


@pytest.mark.parametrize("case", ["proposed", "calibrated", "binary"])
def test_kernel_backend_agrees_with_plain_route(case):
    """The kernel route (on the CPU: the kernel's plain version) against
    the plain batched route on the same dies: the same SA decisions except
    at near-ties.  Calibrated dies reach it with per-chip placement planes;
    the baseline's single-shot reference line has count operand 0.5."""
    design = "baseline" if case == "binary" else "proposed"
    _, tm, x = _layer(design, seed=7, density=0.3)
    x = torch.from_numpy(x)
    cfg = tni.NonidealConfig.all()
    ens = tens.sample_ensemble(prng.PRNGKey(5, device="cpu"), tm, 5, cfg=cfg)
    if case == "calibrated":
        ens = tens.calibrate_ensemble_bias(ens, x)
        assert ens.planes_per_chip()
    plain = teng.ensemble_apply(ens, x, cfg=cfg)
    kern = teng.ensemble_apply_kernel(ens, x, cfg=cfg)
    n, ok = _near_ties(kern, plain, _sa_margin(ens, x, cfg, "single_shot",
                                               256))
    print(f"{case}: kernel-vs-plain near-tie flips per chip {n.tolist()}")
    assert ok
    ref = torch.from_numpy((x.numpy() @ _weights(tm) > 0).astype(np.float32))
    runs = {b: teng.run_mc(prng.PRNGKey(5, device="cpu"), tm, x,
                           ref_bits=ref,
                           mc=teng.McConfig(n_chips=5, chunk_size=5,
                                            backend=b,
                                            calibrate=case == "calibrated"))
            for b in ("plain", "kernel")}
    gap = np.abs(runs["plain"].per_chip["bit_agreement"]
                 - runs["kernel"].per_chip["bit_agreement"]) * BATCH * N_OUT
    assert np.all(np.round(gap) <= n)


def test_kernel_backend_refuses_partial_sum():
    _, tm, x = _layer("baseline")
    with pytest.raises(ValueError, match="single-shot"):
        teng.run_mc(prng.PRNGKey(0, device="cpu"), tm, torch.from_numpy(x),
                    mc=teng.McConfig(n_chips=2, backend="kernel",
                                     accumulation="partial_sum"))
    with pytest.raises(ValueError, match="backend"):
        teng.run_mc(prng.PRNGKey(0, device="cpu"), tm, torch.from_numpy(x),
                    mc=teng.McConfig(n_chips=2, backend="jnp"))


def test_run_mc_metric_fns_and_timers():
    _, tm, x = _layer("proposed", seed=8)
    x = torch.from_numpy(x)
    r = teng.run_mc(
        prng.PRNGKey(0, device="cpu"), tm, x,
        mc=teng.McConfig(n_chips=5, chunk_size=2),
        metric_fns={"max": lambda out: out.amax(dim=(-2, -1))},
        host_metric_fns={"host_ones": lambda out: out.mean(axis=(-2, -1))})
    assert set(r.per_chip) == {"ones_fraction", "max", "host_ones"}
    np.testing.assert_allclose(r.per_chip["host_ones"],
                               r.per_chip["ones_fraction"], rtol=1e-6)
    assert r.n_chips == 5 and r.bias_units is None
    assert r.enqueue_s > 0 and r.host_s > 0
    assert r.enqueue_s + r.device_s + r.host_s <= r.wall_s


@pytest.mark.parametrize("scheme", ["ternary", "binary"])
def test_build_layer_matches_reference(scheme):
    """The CLI's layer from its seed: same planes, word lines and ideal
    reference bits as the JAX CLI (no quantized weight differs)."""
    from repro.launch import mc as jcli
    from repro_torch.launch import mc as tcli
    args = argparse.Namespace(seed=3, fan_in=540, n_out=60, scheme=scheme,
                              bias_rows=32, batch=64, density=0.5)
    jm, jx, jr = jcli.build_layer(args)
    tm, tx, tr = tcli.build_layer(args, "cpu")
    np.testing.assert_array_equal(tm.g_pos.numpy(), np.asarray(jm.g_pos))
    np.testing.assert_array_equal(tm.g_neg.numpy(), np.asarray(jm.g_neg))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


SMALL = ["--chips", "4", "--chunk", "2", "--batch", "16", "--fan-in", "64",
         "--n-out", "16", "--device", "cpu"]


def test_layer_cli_is_the_default_and_runs_on_the_cpu(tmp_path, capsys):
    import json
    from repro_torch.launch import mc as cli
    out = tmp_path / "r.json"
    run_dir = ["--run-dir", str(tmp_path)]
    cli.main(SMALL + ["--ablation", "table2", "--json", str(out)] + run_dir)
    report = json.loads(out.read_text())
    assert report["args"]["network"] == "layer"
    assert list(report["results"]) == [n for n, _ in teng.TABLE2_ABLATION]
    assert report["kernel_launches"] == {"irc_mvm_chips": 0, "irc_mvm": 0,
                                         "ternary_matmul": 0,
                                         "flash_attention": 0, "xla_fma": 0,
                                         "xla_erf_inv": 0, "xla_exp": 0,
                                         "threefry": 0}  # CPU: plain
    assert len(report["results"]["all"]["per_chip_bit_agreement"]) == 4
    cli.main(SMALL + ["--scheme", "binary", "--bias-rows", "0",
                      "--accumulation", "partial_sum", "--json", str(out)]
             + run_dir)
    assert json.loads(out.read_text())["results"]["all"]["bias_units"] is None
    cli.main(SMALL + ["--backend", "kernel", "--calibrate", "--json",
                      str(out)] + run_dir)
    assert len(json.loads(out.read_text())["results"]["all"][
        "bias_units"]) == 4
    assert "devvar" not in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--det-batch", "4"], ["--no-pipeline"], ["--det-steps", "3"],
    ["--network", "detector", "--scheme", "binary"],
    ["--network", "detector", "--backend", "kernel"],
    ["--network", "detector", "--calibrate"],
    ["--network", "detector", "--batch", "8"]])
def test_cli_refuses_flags_of_the_other_network(argv):
    from repro_torch.launch import mc as cli
    with pytest.raises(SystemExit, match="does not take"):
        cli.main(argv + ["--device", "cpu"])
