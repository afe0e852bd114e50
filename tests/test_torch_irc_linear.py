"""The rest of the port's `core` against the JAX package's: the IR-drop
readout, the SA offset, the multi-macro `sensed_diff` readout, the tiling
helpers, the `IRCLinear` layer and the Table I calibration statistics.

Same numpy inputs and the same keys on both sides; the reference's calls
that sample dies are jitted, as its sweeps run them, except
`IRCLinear.init`, which the reference runs eagerly.  Bit for bit: the SA
offset, `sensed_diff` (whose threshold at zero is `resolve_sa`'s decision),
the tiling helpers, `IRCLinear.init` and `layer_current_stats`; the
ensembles' sensed differences within 1e-4 (their line currents are summed
in other orders, as the "diff" readout's).  The tiled structural
evaluation follows the
near-tie rule: decisions may differ only where the port's margin (its
summed sensed difference, or a line current's distance from the sensing
window) is below `NEAR_TIE_TOL`; the flip count is printed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import calibration as jcal  # noqa: E402
from repro.core import crossbar as jcb  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import nonideal as jni  # noqa: E402
from repro.core.macro import MacroSpec as JSpec  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import calibration as tcal  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core.macro import MacroSpec as TSpec  # noqa: E402
from repro_torch.kernels.ref import NEAR_TIE_TOL  # noqa: E402

torch.set_num_threads(2)

ALPHA = 1.5e-5
EFFECTS = {"sa": dict(sa_variation=True), "range": dict(sensing_range=True),
           "all": dict(device_variation=True, nonlinearity=True,
                       sa_variation=True, sensing_range=True, ir_drop=True)}


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this module's
    tests, the earlier settings restored after them."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


def _rng(*salt):
    return np.random.default_rng([23, *salt])


def _same_bits(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    n = int(np.sum(port.view(np.uint32) != ref.view(np.uint32)))
    assert n == 0, f"{what}: {n} of {ref.size} float32 results differ"


def _lines(seed, shape=(48, 60)):
    """Line currents in and around the sensing window and their counts."""
    r = _rng(seed)
    i_pos = (r.random(shape) * 80 - 2).astype(np.float32)
    i_neg = (r.random(shape) * 80 - 2).astype(np.float32)
    p = np.floor(r.random(shape) * 400).astype(np.float32)
    return i_pos, i_neg, p


def test_core_exports_the_reference_surface():
    import repro.core as jcore
    modules = ("macro", "nonideal", "ternary", "mapping", "crossbar",
               "calibration")
    public = {n for n in dir(jcore) if not n.startswith("_")
              and n not in modules}
    missing = sorted(n for n in public if not hasattr(tcore, n))
    assert not missing, missing


@pytest.mark.parametrize("nb", [4, 9, 16, 18])
def test_apply_ir_drop(nb):
    """The weighted sum adds as XLA adds it (bit for bit from the same
    factors); the factors' minor-axis contraction is a library matmul in
    XLA whose order changes with nb, so the totals agree to a few ulps."""
    from repro_torch import xla_order as xo
    bl = (_rng(1, nb).random((96, nb)) * 30).astype(np.float32)
    ref = np.asarray(jax.jit(lambda b: jni.apply_ir_drop(b, ALPHA))(bl))
    got = tni.apply_ir_drop(torch.from_numpy(bl), ALPHA).numpy()
    np.testing.assert_allclose(got, ref, rtol=4e-7, atol=0)
    f = np.asarray(jax.jit(lambda b: jni.ir_drop_factors(b, ALPHA))(bl))
    _same_bits(xo.seq_fma_sum(torch.from_numpy(bl), torch.from_numpy(f), -1),
               jax.jit(lambda b, w: jnp.sum(b * w, axis=-1))(bl, f),
               "jnp.sum(blocks * factors, axis=-1)")


def test_sa_offset():
    _, _, p = _lines(2)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda k, q: jni.sa_offset(k, q, extra_units=1.5))(key, p)
    got = tni.sa_offset(prng.PRNGKey(3, device="cpu"), torch.from_numpy(p),
                        extra_units=1.5)
    _same_bits(got, ref, "sa_offset")


@pytest.mark.parametrize("effects", list(EFFECTS))
def test_sensed_diff_and_its_threshold(effects):
    ip, in_, p = _lines(4)
    jcfg = jni.NonidealConfig(**EFFECTS[effects])
    tcfg = tni.NonidealConfig(**EFFECTS[effects])
    ref = jax.jit(lambda k, a, b, q: jni.sensed_diff(
        k, a, b, q, jcfg, sa_extra_units=0.5))(jax.random.PRNGKey(5), ip,
                                                in_, p)
    args = (prng.PRNGKey(5, device="cpu"), torch.from_numpy(ip),
            torch.from_numpy(in_), torch.from_numpy(p), tcfg)
    got = tni.sensed_diff(*args, sa_extra_units=0.5)
    _same_bits(got, ref, "sensed_diff")
    assert torch.equal((got > 0).float(),
                       tni.resolve_sa(*args, sa_extra_units=0.5))


def test_tiling_helpers():
    spec_t, spec_j = TSpec(rows=128), JSpec(rows=128)
    w = np.sign(_rng(6).standard_normal((300, 12))).astype(np.float32)
    w[_rng(7).random(w.shape) < 0.3] = 0.0
    jm = jmap.ternary_planes(jnp.asarray(w), bias_rows=8)
    tm = tmap.ternary_planes(torch.from_numpy(w), bias_rows=8)
    jgp, jgn, jn = jmap.tile_rows(jm, spec_j)
    tgp, tgn, tn = tmap.tile_rows(tm, spec_t)
    assert tn == jn == 3
    _same_bits(tgp, jgp, "tile_rows g_pos")
    _same_bits(tgn, jgn, "tile_rows g_neg")
    x = _rng(8).random((5, 308)).astype(np.float32)
    _same_bits(tmap.pad_inputs_for_tiles(torch.from_numpy(x), tn, spec_t),
               jmap.pad_inputs_for_tiles(jnp.asarray(x), jn, spec_j),
               "pad_inputs_for_tiles")


@pytest.mark.parametrize("use_bn", [False, True])
def test_irc_linear_init_is_the_eager_reference(use_bn):
    for fan_in, fan_out in ((300, 6), (1200, 16), (7, 3)):
        c = dict(fan_in=fan_in, fan_out=fan_out, use_bn=use_bn)
        jp = jcb.IRCLinear(jcb.IRCLinearConfig(**c)).init(
            jax.random.PRNGKey(fan_in))
        tp = tcb.IRCLinear(tcb.IRCLinearConfig(**c)).init(
            prng.PRNGKey(fan_in, device="cpu"))
        _same_bits(tp["w"], jp["w"], "IRCLinear.init w")
        assert set(tp) == set(jp)
        if use_bn:
            for k in ("gamma", "beta", "mean", "var"):
                _same_bits(tp["bn"][k], jp["bn"][k], k)


def _port_margin(lin, params, x, key, cfg, sa_extra):
    """The port's decision margin per output: |sum of the tiles' sensed
    differences|, and where the sensing range is on, each tile's line
    currents' distance from the window's edges."""
    spec = lin.spec
    x_bits = (x > 0).float()
    total, edge, offset = 0.0, None, 0
    for t, tile in enumerate(lin.map_to_planes(params)):
        x_t = x_bits[..., offset:offset + tile.fan_in]
        offset += tile.fan_in
        k_t = prng.fold_in(key, t)
        total = total + tcb.crossbar_forward(
            k_t, x_t, tile, cfg=cfg, spec=spec, sa_extra_units=sa_extra,
            output="sensed_diff")
        ep, en, _ = tcb.sample_chip_planes(k_t, tile.g_pos, tile.g_neg,
                                           tile.scheme, cfg, spec)
        x_e = tmap.extend_inputs(x_t, tile)
        lines = [tcb._accumulate(tcb._block_reduce(x_e, e, spec.ir_block),
                                 tcb._block_reduce(x_e, g, spec.ir_block),
                                 cfg, spec, "single_shot", 256)[0]
                 for e, g in ((ep, tile.g_pos), (en, tile.g_neg))]
        lo, hi = torch.minimum(*lines), torch.maximum(*lines)
        d = torch.minimum((lo - spec.sense_low_units).abs(),
                          (hi - spec.sense_high_units).abs())
        edge = d if edge is None else torch.minimum(edge, d)
    margin = total.abs()
    return torch.minimum(margin, edge) if cfg.sensing_range else margin


@pytest.mark.parametrize("case", ["fan_in_300_rows_128", "wide_1200"])
@pytest.mark.parametrize("effects", ["sa", "all"])
def test_irc_linear_eval_over_tiles(case, effects):
    """`apply(mode="eval")` over several macros: tile t keyed fold_in(key,
    t), the sensed differences summed and thresholded; against the jitted
    reference under the near-tie rule."""
    rows, fan_in, fan_out, batch = ((128, 300, 6, 16) if case.startswith(
        "fan_in") else (1024, 1200, 16, 8))
    c = dict(fan_in=fan_in, fan_out=fan_out, bias_rows=8)
    jlin = jcb.IRCLinear(jcb.IRCLinearConfig(**c), spec=JSpec(rows=rows))
    tlin = tcb.IRCLinear(tcb.IRCLinearConfig(**c), spec=TSpec(rows=rows))
    jp = jlin.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    assert len(tlin.map_to_planes(tp)) == len(jlin.map_to_planes(jp)) > 1
    x = _rng(9, fan_in).standard_normal((batch, fan_in)).astype(np.float32)
    jcfg = jni.NonidealConfig(**EFFECTS[effects])
    tcfg = tni.NonidealConfig(**EFFECTS[effects])
    ref = np.asarray(jax.jit(lambda p, v, k: jlin.apply(
        p, v, key=k, mode="eval", cfg=jcfg, sa_extra_units=1.0))(
            jp, x, jax.random.PRNGKey(2)))
    key = prng.PRNGKey(2, device="cpu")
    got = tlin.apply(tp, torch.from_numpy(x), key=key, mode="eval",
                     cfg=tcfg, sa_extra_units=1.0)
    assert got.shape == ref.shape == (batch, fan_out)
    mism = got.numpy() != ref
    margin = _port_margin(tlin, tp, torch.from_numpy(x), key, tcfg, 1.0)
    print(f"{case}, {effects}: {int(mism.sum())} of {ref.size} decisions "
          f"differ (near-ties)")
    assert bool((margin[torch.from_numpy(mism)] < NEAR_TIE_TOL).all())


def test_irc_linear_diff_output_and_train_mode():
    """output="diff" sums the tiles' ideal differences: the ideal matmul;
    mode="train" is `irc_linear_train`."""
    c = dict(fan_in=300, fan_out=4, bias_rows=8, output="diff")
    lin = tcb.IRCLinear(tcb.IRCLinearConfig(**c),
                        spec=TSpec(rows=128, hrs_leak=0.0))
    params = lin.init(prng.PRNGKey(0, device="cpu"))
    x = torch.from_numpy(_rng(10).standard_normal((4, 300))
                         .astype(np.float32))
    d = lin.apply(params, x, key=prng.PRNGKey(2, device="cpu"), mode="eval")
    w_q = torch.round(lin.quantized_weights(params))
    torch.testing.assert_close(d, (x > 0).float() @ w_q, atol=1e-3, rtol=0)
    key = prng.PRNGKey(3, device="cpu")
    assert torch.equal(lin.apply(params, x, key=key),
                       tcb.irc_linear_train(key, x, params["w"],
                                            output="diff"))
    with pytest.raises(ValueError, match="mode"):
        lin.apply(params, x, key=key, mode="qat")


def test_ensemble_sensed_diff_matches_reference():
    from repro.mc import engine as jeng
    from repro.mc.ensemble import sample_ensemble as jsample
    from repro_torch.mc import engine as teng
    from repro_torch.mc.ensemble import sample_ensemble as tsample
    w = np.sign(_rng(11).standard_normal((200, 12))).astype(np.float32)
    w[_rng(12).random(w.shape) < 0.5] = 0.0
    x = (_rng(13).random((16, 200)) < 0.5).astype(np.float32)
    jm = jmap.ternary_planes(jnp.asarray(w), bias_rows=16)
    tm = tmap.ternary_planes(torch.from_numpy(w), bias_rows=16)
    jens = jax.jit(lambda k: jsample(k, jm, 3, cfg=jni.NonidealConfig.all())
                   )(jax.random.PRNGKey(14))
    tens = tsample(prng.PRNGKey(14, device="cpu"), tm, 3,
                   cfg=tni.NonidealConfig.all())
    kw = dict(output="sensed_diff", sa_extra_units=0.5)
    ref = np.asarray(jeng.ensemble_apply(jens, jnp.asarray(x),
                                         cfg=jni.NonidealConfig.all(), **kw))
    got = teng.ensemble_apply(tens, torch.from_numpy(x),
                              cfg=tni.NonidealConfig.all(), **kw)
    # the line currents are summed in other float32 orders on the two
    # sides (as `ensemble_apply`'s "diff"); the periphery terms match
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    binary = teng.ensemble_apply(tens, torch.from_numpy(x),
                                 cfg=tni.NonidealConfig.all(),
                                 sa_extra_units=0.5)
    assert torch.equal((got > 0).float(), binary)


def test_layer_current_stats_is_the_reference():
    w = np.sign(_rng(15).standard_normal((540, 60))).astype(np.float32)
    w[_rng(16).random(w.shape) < 0.6] = 0.0
    x = (_rng(17).random((32, 540)) < 0.5).astype(np.float32)
    jm = jmap.ternary_planes(jnp.asarray(w), bias_rows=32)
    tm = tmap.ternary_planes(torch.from_numpy(w), bias_rows=32)
    ref = jax.jit(lambda k, v: jcal.layer_current_stats(k, v, jm))(
        jax.random.PRNGKey(18), x)
    got = tcal.layer_current_stats(prng.PRNGKey(18, device="cpu"),
                                   torch.from_numpy(x), tm)
    for name, g, r in zip(("i_pos", "i_neg", "p_pair"), got, ref):
        _same_bits(g, r, f"layer_current_stats {name}")
