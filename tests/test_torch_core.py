"""Core crossbar physics of the port against the JAX package on the same
numpy inputs and the same PRNG keys: quantizers, plane mapping, the
nonlinearity ratio, IR-drop factors, per-chip plane sampling, the
single-chip structural sim, and the detector's im2col/group mapping."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import crossbar as jcb  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import nonideal as jni  # noqa: E402
from repro.core import ternary as jter  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core import ternary as tter  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def partitionable():
    """Both packages on the partitionable threefry scheme for this module's
    tests, the earlier settings restored after them: the same key gives
    the same dies on both sides, and the suite runs once, not once per
    scheme (`tests/test_torch_prng.py` and `test_torch_layer_mc.py` hold
    both schemes)."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("axis", [None, (0, 1), 0])
def test_ternary_quantize_matches(axis):
    w = _rng(1).standard_normal((540, 60, 3)).astype(np.float32)
    j = np.asarray(jter.ternary_quantize(jnp.asarray(w), axis=axis))
    t = tter.ternary_quantize(torch.from_numpy(w), axis=axis).numpy()
    np.testing.assert_array_equal(j, t)
    assert set(np.unique(t)) <= {-1.0, 0.0, 1.0}


def test_binary_quantizers_match():
    x = _rng(2).standard_normal((50, 7)).astype(np.float32)
    x[0, 0] = 0.0
    np.testing.assert_array_equal(
        np.asarray(jter.binary_quantize(jnp.asarray(x))),
        tter.binary_quantize(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jter.binary_activation(jnp.asarray(x))),
        tter.binary_activation(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("bias_rows", [0, 16, 32])
def test_ternary_planes_match(bias_rows):
    w = _rng(3).standard_normal((540, 60)).astype(np.float32)
    jq = jter.ternary_quantize(jnp.asarray(w))
    jm = jmap.ternary_planes(jq, bias_rows=bias_rows)
    tm = tmap.ternary_planes(torch.tensor(np.asarray(jq)),
                             bias_rows=bias_rows)
    np.testing.assert_array_equal(np.asarray(jm.g_pos), tm.g_pos.numpy())
    np.testing.assert_array_equal(np.asarray(jm.g_neg), tm.g_neg.numpy())
    assert (tm.rows, tm.fan_in, tm.bias_rows) == (jm.rows, jm.fan_in,
                                                  jm.bias_rows)
    x = (_rng(4).random((5, 540)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jmap.extend_inputs(jnp.asarray(x), jm)),
        tmap.extend_inputs(torch.from_numpy(x), tm).numpy())


def test_nonlinearity_ratio_matches():
    p = np.concatenate([np.arange(0, 400, dtype=np.float32),
                        np.array([-3.0, 0.25, 0.5, 139.9, 140.1],
                                 np.float32)])
    np.testing.assert_allclose(
        tni.nonlinearity_ratio(torch.from_numpy(p)).numpy(),
        np.asarray(jni.nonlinearity_ratio(jnp.asarray(p))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("axis", [-1, -2, 0])
def test_ir_drop_factors_match(axis):
    blocks = (_rng(5).random((4, 18, 60)) * 30).astype(np.float32)
    np.testing.assert_allclose(
        tni.ir_drop_factors(torch.from_numpy(blocks), 1.5e-5,
                            axis=axis).numpy(),
        np.asarray(jni.ir_drop_factors(jnp.asarray(blocks), 1.5e-5,
                                       axis=axis)),
        rtol=1e-6, atol=1e-7)


def _mapped(seed=6, fan_in=540, n_out=60, bias_rows=32):
    w = _rng(seed).standard_normal((fan_in, n_out)).astype(np.float32)
    jq = jter.ternary_quantize(jnp.asarray(w))
    return (jmap.ternary_planes(jq, bias_rows=bias_rows),
            tmap.ternary_planes(torch.tensor(np.asarray(jq)),
                                bias_rows=bias_rows))


@pytest.mark.parametrize("variation", [True, False])
def test_sample_chip_planes_match(partitionable, variation):
    jm, tm = _mapped()
    cfg_j = jni.NonidealConfig(device_variation=variation)
    cfg_t = tni.NonidealConfig(device_variation=variation)
    key = jax.random.fold_in(jax.random.PRNGKey(8), 3)
    tkey = prng.fold_in(prng.PRNGKey(8, device="cpu"), 3)
    # jitted, as the reference's ensembles sample: XLA folds sigma into the
    # normal's sqrt(2) there
    jep, jen, jks = jax.jit(lambda k: jcb.sample_chip_planes(
        k, jm.g_pos, jm.g_neg, "ternary", cfg_j))(key)
    tep, ten, tks = tcb.sample_chip_planes(tkey, tm.g_pos, tm.g_neg,
                                           "ternary", cfg_t)
    np.testing.assert_array_equal(tep.numpy(), np.asarray(jep))
    np.testing.assert_array_equal(ten.numpy(), np.asarray(jen))
    np.testing.assert_array_equal(tks.numpy(),
                                  np.asarray(jks).astype(np.int64))
    # a batch of chip keys is the vmap of the single-chip draw
    ids = jnp.arange(3, dtype=jnp.uint32)
    jk = jax.vmap(lambda i: jax.random.fold_in(key, i))(ids)
    jb = jax.jit(jax.vmap(lambda k: jcb.sample_chip_planes(
        k, jm.g_pos, jm.g_neg, "ternary", cfg_j)[0]))(jk)
    tb = tcb.sample_chip_planes(prng.fold_in(tkey, torch.arange(3)),
                                tm.g_pos, tm.g_neg, "ternary", cfg_t)[0]
    assert tb.shape == (3, 572, 60)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def _reference_margin(key, x, jm, cfg):
    """|i+ - i- + SA offset| of the reference, the margin of its decision
    (and, with the sensing range on, the line currents' distance from the
    window's edges)."""
    spec = jcb.DEFAULT_MACRO
    ep, en, k_sa = jax.jit(lambda k: jcb.sample_chip_planes(
        k, jm.g_pos, jm.g_neg, "ternary", cfg))(key)
    x_ext = jmap.extend_inputs(x, jm)
    i_p, p_p = jcb._accumulate(jcb._block_reduce(x_ext, ep, 32),
                               jcb._block_reduce(x_ext, jm.g_pos, 32), cfg,
                               spec, "single_shot", 256)
    i_n, p_n = jcb._accumulate(jcb._block_reduce(x_ext, en, 32),
                               jcb._block_reduce(x_ext, jm.g_neg, 32), cfg,
                               spec, "single_shot", 256)
    k_off, _ = jax.random.split(k_sa)
    margin = jnp.abs(i_p - i_n + jni.sa_offset(k_off, p_p + p_n, spec))
    lo, hi = jnp.minimum(i_p, i_n), jnp.maximum(i_p, i_n)
    margin = jnp.minimum(margin, jnp.minimum(
        jnp.abs(lo - spec.sense_low_units), jnp.abs(hi - spec.sense_high_units)))
    return np.asarray(margin)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crossbar_forward_same_sa_bits(partitionable, seed):
    """All effects on, the same key: the same SA decisions, except where the
    reference's decision margin is below 1e-4 (counted)."""
    jm, tm = _mapped(seed=10 + seed)
    x = (_rng(seed).random((64, 540)) < 0.5).astype(np.float32)
    key = jax.random.PRNGKey(100 + seed)
    tkey = prng.PRNGKey(100 + seed, device="cpu")
    j = np.asarray(jcb.crossbar_forward(key, jnp.asarray(x), jm,
                                        cfg=jni.NonidealConfig.all()))
    t = tcb.crossbar_forward(tkey, torch.from_numpy(x), tm,
                             cfg=tni.NonidealConfig.all()).numpy()
    mism = j != t
    print(f"SA mismatches: {int(mism.sum())} of {t.size}")
    if mism.any():
        margin = _reference_margin(key, jnp.asarray(x), jm,
                                   jni.NonidealConfig.all())
        assert np.all(margin[mism] < 1e-4), margin[mism]
    diff_j = np.asarray(jcb.crossbar_forward(key, jnp.asarray(x), jm,
                                             cfg=jni.NonidealConfig.all(),
                                             output="diff"))
    diff_t = tcb.crossbar_forward(tkey, torch.from_numpy(x), tm,
                                  cfg=tni.NonidealConfig.all(),
                                  output="diff").numpy()
    np.testing.assert_allclose(diff_t, diff_j, atol=1e-4, rtol=0)


def test_partial_sum_and_binary_scheme_raise():
    """Partial sums and the binary scheme run (the baseline design); an
    unknown accumulation mode or mapping scheme raises."""
    _, tm = _mapped()
    x = torch.ones((2, 540))
    key = prng.PRNGKey(0, device="cpu")
    out = tcb.crossbar_forward(key, x, tm, cfg=tni.NonidealConfig.all(),
                               accumulation="partial_sum")
    assert out.shape == (2, 60)
    with pytest.raises(ValueError, match="accumulation"):
        tcb.crossbar_forward(key, x, tm, accumulation="chunked")
    ep, en, _ = tcb.sample_chip_planes(key, tm.g_pos, tm.g_neg, "binary",
                                       tni.NonidealConfig.all())
    assert ep.shape == en.shape == tm.g_pos.shape
    with pytest.raises(ValueError, match="scheme"):
        tcb.sample_chip_planes(key, tm.g_pos, tm.g_neg, "quaternary",
                               tni.NonidealConfig.all())


def _detectors():
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    from repro_torch.configs import yolo_irc as tcfg
    from repro_torch.convert import params_from_jax
    from repro_torch.models.detector import IRCDetector as TDet
    jdet = JDet(jcfg.smoke("ternary"))
    params = jdet.init(jax.random.PRNGKey(0))
    return jdet, params, TDet(tcfg.smoke()), params_from_jax(
        jax.device_get(params), device="cpu")


def test_im2col_groups_and_group_mappings_match():
    """The per-layer parity that catches a wrong im2col row order: the
    reference's channel-major patches regrouped spatial-major per group."""
    jdet, jp, tdet, tp = _detectors()
    x = (_rng(7).random((2, 8, 8, 120)) < 0.5).astype(np.float32)
    j = np.asarray(jdet._im2col_groups(jnp.asarray(x), 120, 2))
    t = tdet._im2col_groups(torch.from_numpy(x), 120, 2).numpy()
    np.testing.assert_array_equal(j, t)
    xc = np.stack([x, 1.0 - x])                       # a chips axis
    np.testing.assert_array_equal(
        np.asarray(jdet._im2col_groups(jnp.asarray(xc), 120, 2)),
        tdet._im2col_groups(torch.from_numpy(xc), 120, 2).numpy())
    for jm, tm in zip(jdet.group_mappings(jp["s1b0"], 120, 120),
                      tdet.group_mappings(tp["s1b0"], 120, 120)):
        np.testing.assert_array_equal(np.asarray(jm.g_pos), tm.g_pos.numpy())
        np.testing.assert_array_equal(np.asarray(jm.g_neg), tm.g_neg.numpy())


def test_detector_eval_mode_matches(partitionable):
    """Single-chip structural eval of the whole smoke detector, same params
    and key: head predictions agree within 1e-4 on >= 99% of elements."""
    from repro.core import NonidealConfig as JNI
    jdet, jp, tdet, tp = _detectors()
    calib = _rng(8).random((4, 32, 32, 3)).astype(np.float32)
    imgs = _rng(9).random((2, 32, 32, 3)).astype(np.float32)
    jp = jdet.calibrate_bn(jp, jnp.asarray(calib))
    tp = tdet.calibrate_bn(tp, torch.from_numpy(calib))
    np.testing.assert_allclose(tp["stem_bn"]["var"].numpy(),
                               np.asarray(jp["stem_bn"]["var"]), rtol=1e-5)
    j = np.asarray(jdet.apply(jp, jnp.asarray(imgs), mode="eval",
                              key=jax.random.PRNGKey(4), cfg_ni=JNI.all()))
    t = tdet.apply(tp, torch.from_numpy(imgs), mode="eval",
                   key=prng.PRNGKey(4, device="cpu"),
                   cfg_ni=tni.NonidealConfig.all()).numpy()
    assert t.shape == j.shape
    assert np.mean(np.abs(t - j) <= 1e-4) >= 0.99
