"""The port's float32 orders against XLA's, bit for bit.

Each helper of `repro_torch.xla_order`, and each port function built on
them, is held against the `jnp` call of the JAX package that it stands in
for, jitted as the reference runs it, on random inputs at the detector's
shapes: 16, 17 and 18 IR blocks (R = 540 + 32 = 572 rows gives 18) of 60
columns.  A jax release that changes one of these orders fails the test
that names the op.  The orders were read on jax 0.9.0 with XLA's CPU
backend.

The smoke-geometry detector at the full width's 572 rows (two stages, four
chips, all effects) closes the file: its head against the reference's
kernel-oracle route.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch import xla_order as xo  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core.macro import DEFAULT_MACRO as TMACRO  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BLOCKS = (16, 17, 18)
B, N = 96, 60
ALPHA = 1.5e-5


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this module's
    tests, the earlier settings restored after them: the same key gives
    the same dies on both sides, and the suite runs once, not once per
    scheme (`tests/test_torch_prng.py` and `test_torch_layer_mc.py` hold
    both schemes)."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


def _rng(*salt):
    return np.random.default_rng([11, *salt])


def _same_bits(port, ref, what):
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    n = int(np.sum(port.view(np.uint32) != ref.view(np.uint32)))
    assert n == 0, f"{what}: {n} of {ref.size} float32 results differ"


def _blocks(nb, *salt):
    """Block currents [B, nb, N] of the size a 32-row block gives."""
    return (_rng(nb, *salt).random((B, nb, N)) * 30).astype(np.float32)


@pytest.mark.parametrize("nb", BLOCKS)
def test_seq_sum_is_jnp_sum_over_blocks(nb):
    bl = _blocks(nb, 1)
    ref = jax.jit(lambda b: jnp.sum(b, axis=1))(bl)
    _same_bits(xo.seq_sum(torch.from_numpy(bl), 1), ref, "jnp.sum(axis=1)")


@pytest.mark.parametrize("nb", BLOCKS)
def test_seq_fma_sum_is_jnp_weighted_sum(nb):
    bl = _blocks(nb, 2)
    f = _rng(nb, 3).random((B, nb, N)).astype(np.float32)
    ref = jax.jit(lambda b, w: jnp.sum(b * w, axis=1))(bl, f)
    _same_bits(xo.seq_fma_sum(torch.from_numpy(bl), torch.from_numpy(f), 1),
               ref, "jnp.sum(blocks * factors, axis=1)")


@pytest.mark.parametrize("nb", BLOCKS + (33,))
def test_scan16_is_jnp_cumsum(nb):
    bl = np.moveaxis(_blocks(nb, 4), 1, 2)             # [B, N, nb]
    items = torch.from_numpy(bl.copy()).unbind(-1)
    _same_bits(torch.stack(list(xo.scan16_iter(items)), -1),
               jax.jit(lambda b: jnp.cumsum(b, axis=-1))(bl),
               "jnp.cumsum")
    suffix = list(xo.scan16_iter(items[::-1]))[::-1]
    _same_bits(torch.stack(suffix, -1),
               jax.jit(lambda b: jnp.cumsum(b[..., ::-1], axis=-1)[..., ::-1]
                       )(bl), "jnp.cumsum of the reversed axis")


def test_fma_is_xla_contraction():
    """`1 - alpha * cum` under jit is one fused multiply-add."""
    cum = (_rng(6).random((B, 18, N)) * 3000).astype(np.float32)
    ref = jax.jit(lambda c: 1.0 - ALPHA * c)(cum)
    _same_bits(xo.fma(-ALPHA, torch.from_numpy(cum), 1.0), ref,
               "1 - alpha * cum")
    a, b, c = (_rng(7, i).standard_normal(4096).astype(np.float32)
               for i in range(3))
    _same_bits(xo.fma(*map(torch.from_numpy, (a, b, c))),
               jax.jit(lambda a, b, c: a * b + c)(a, b, c), "a * b + c")


def test_fma_rounds_once():
    """3 * (1 + 2^-23) lies on a float32 midpoint; a tiny addend decides the
    rounding, which a float64 sum rounded twice would lose."""
    a = torch.tensor([3.0, 3.0])
    b = torch.tensor([1.0 + 2.0 ** -23] * 2)
    c = torch.tensor([2.0 ** -60, -2.0 ** -60])
    ulp = 2.0 ** -22
    assert xo.fma(a, b, c).tolist() == [3.0 + 2 * ulp, 3.0 + ulp]


def _log1p_inputs():
    """log1p's domain (-1, inf): the normals' x * -x in (-1, 0], both
    branches' edge, subnormals and large values."""
    r = _rng(20)
    edge = np.float32([0.0, -0.0, 1e-40, -1e-40, 1.17e-38, -0.5, 0.41421,
                       -0.29289, 0.4142136, -0.9999999, 1e30])
    return np.concatenate([-r.random(100_000), r.random(50_000),
                           r.random(20_000) * 1e3, edge]).astype(np.float32)


def _exp_inputs():
    """The variation mask's sigma * z, the clamps and subnormal results."""
    r = _rng(21)
    edge = np.float32([0.0, -0.0, 88.7, 89.0, -87.3, -88.0, -103.0, -104.0,
                       1e-30, -1e-30])
    return np.concatenate([r.standard_normal(100_000) * 0.4245 * 3,
                           r.uniform(-110, 110, 50_000),
                           edge]).astype(np.float32)


def _erf_inv_inputs():
    """jax.random.normal's uniforms on (nextafter(-1, 0), 1), both
    polynomials' edge (w = 5) and the poles."""
    r = _rng(22)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    edge = np.float32([0.0, -0.0, 1.0, -1.0, 1e-30, below_one, -below_one,
                       0.99662, -0.99663])
    return np.concatenate([r.uniform(-1, 1, 150_000),
                           edge]).astype(np.float32)


def test_log1p_is_jnp_log1p():
    x = _log1p_inputs()
    _same_bits(xo.log1p(torch.from_numpy(x)), jax.jit(jnp.log1p)(x),
               "jnp.log1p")


def test_exp_is_jnp_exp():
    x = _exp_inputs()
    _same_bits(xo.exp(torch.from_numpy(x)), jax.jit(jnp.exp)(x), "jnp.exp")


@pytest.mark.parametrize("scale", [1.0, 0.4245 * np.sqrt(2)],
                         ids=["1", "sigma_sqrt2"])
def test_erf_inv_is_lax_erf_inv(scale):
    """erf_inv times a float32 constant (the normal's folded sqrt(2))."""
    s = np.float32(scale)
    u = _erf_inv_inputs()
    _same_bits(xo.erf_inv(torch.from_numpy(u), float(s)),
               jax.jit(lambda v: s * jax.lax.erf_inv(v))(u),
               "lax.erf_inv")


def _erf_inputs():
    """Across the float32 range: the normals the measured mask feeds the
    cdf, every branch edge of erf, erfc and ndtr (0.5 sqrt 2, 1, 2, the
    erf clamp, erfc's underflow), subnormals, zeros and the infinities."""
    r = _rng(25)
    edge = np.float32([0.0, -0.0, 1e-40, -1e-40, 1.17e-38, 0.5, 0.70710677,
                       -0.70710677, 1.0, -1.0, 2.0, -2.0, 3.74392128, 5.0,
                       9.3, 9.5, 10.0, 30.0, 1e30, -1e30, np.inf, -np.inf])
    edge = np.concatenate([edge, np.nextafter(edge, np.float32(np.inf)),
                           np.nextafter(edge, np.float32(-np.inf))])
    mags = 10.0 ** r.uniform(-38, 38, 50_000)
    return np.concatenate([r.standard_normal(100_000) * 1.5,
                           r.uniform(-12, 12, 50_000),
                           mags * r.choice([-1.0, 1.0], mags.size),
                           edge]).astype(np.float32)


@pytest.mark.parametrize("name", ["erf", "erfc", "ndtr"])
def test_erf_family_is_jax(name):
    ref = {"erf": jax.lax.erf, "erfc": jax.lax.erfc,
           "ndtr": jax.scipy.stats.norm.cdf}[name]
    x = _erf_inputs()
    _same_bits(getattr(xo, name)(torch.from_numpy(x)), jax.jit(ref)(x), name)


def test_interp_is_jnp_interp():
    """On a sampled grid of [0, 1] and beyond, on every quantile and on
    both sides of it, for the measured table."""
    from repro.device import MeasuredDeviceModel
    m = MeasuredDeviceModel.from_file()
    xp, fp = np.float32(m.var_q), np.float32(m.var_factor)
    r = _rng(26)
    x = np.concatenate([r.random(200_000), r.uniform(-1, 2, 10_000), xp,
                        np.nextafter(xp, np.float32(0)),
                        np.nextafter(xp, np.float32(1)),
                        [0.0, -0.0, 1.0, 1e-30]]).astype(np.float32)
    _same_bits(xo.interp(*map(torch.from_numpy, (x, xp, fp))),
               jax.jit(jnp.interp)(x, xp, fp), "jnp.interp")


def test_elementwise_ops_take_plain_versions_on_the_cpu():
    """On CPU tensors the kernel wrappers are the plain versions, bit for
    bit, and count no launch; other devices raise."""
    from repro_torch.kernels import ops, xla_math
    ops.reset_launches()
    a, b, c = (torch.from_numpy(_rng(23, i).standard_normal((4, 1, 60))
                                .astype(np.float32)) for i in range(3))
    bc = b.expand(4, 96, 60).transpose(0, 1)
    _same_bits(ops.xla_fma(a.transpose(0, 1), bc, 0.5),
               xo.fma_plain(a.transpose(0, 1), bc, 0.5), "xla_fma")
    u = torch.from_numpy(_erf_inv_inputs())
    _same_bits(ops.xla_erf_inv(u, 1.5), xo.erf_inv_plain(u, 1.5),
               "xla_erf_inv")
    x = torch.from_numpy(_exp_inputs())
    _same_bits(ops.xla_exp(x), xo.exp_plain(x), "xla_exp")
    assert {k: ops.LAUNCHES[k] for k in ("xla_fma", "xla_erf_inv",
                                         "xla_exp")} == {
        "xla_fma": 0, "xla_erf_inv": 0, "xla_exp": 0}
    meta = torch.empty(3, device="meta")
    for call in (lambda: ops.xla_fma(meta, meta, 1.0),
                 lambda: ops.xla_erf_inv(meta), lambda: ops.xla_exp(meta)):
        with pytest.raises(RuntimeError, match="CPU or CUDA"):
            call()
    with pytest.raises(ValueError, match="float32"):
        ops.xla_exp(x.double())
    with pytest.raises(ValueError, match="several devices"):
        ops.xla_fma(a, meta, 1.0)
    assert xla_math.SOURCE.is_file()
    assert xla_math.SOURCE.name == "xla_math.cu"


@pytest.mark.gpu
def test_elementwise_kernels_match_plain_versions_on_the_card():
    """`csrc/xla_math.cu` against the plain versions, bit for bit: the
    fused multiply-add with broadcast, strided and scalar operands, erf_inv
    and exp over their domains."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = lambda *shape, i: torch.from_numpy(
        _rng(24, i).standard_normal(shape).astype(np.float32)).to(dev)
    a, b, c = g(4, 1, 60, i=0), g(1, 96, 60, i=1), g(4, 96, 60, i=2)
    cases = [(a, b, c), (a, b, 0.25), (-1.5e-5, c, 1.0),
             (c.transpose(0, 2), 2.0, c.transpose(0, 2)),
             (torch.tensor(3.0, device=dev), b, a)]
    ops.reset_launches()
    for x, y, z in cases:
        _same_bits(ops.xla_fma(x, y, z).cpu(), xo.fma_plain(x, y, z).cpu(),
                   "xla_fma")
    u = torch.from_numpy(_erf_inv_inputs()).to(dev)
    _same_bits(ops.xla_erf_inv(u, 0.6).cpu(), xo.erf_inv_plain(u, 0.6).cpu(),
               "xla_erf_inv")
    e = torch.from_numpy(_exp_inputs()).to(dev)
    _same_bits(ops.xla_exp(e).cpu(), xo.exp_plain(e).cpu(), "xla_exp")
    assert (ops.LAUNCHES["xla_fma"], ops.LAUNCHES["xla_erf_inv"],
            ops.LAUNCHES["xla_exp"]) == (len(cases), 1, 1)


@pytest.mark.parametrize("module", ["kernels.ref", "core.nonideal"])
def test_nl_ratio_is_reference(module):
    from repro.kernels.ref import nl_ratio as jnl
    p = np.concatenate([np.arange(-2, 330, dtype=np.float32),
                        (_rng(8).random(4096) * 400 - 20).astype(np.float32)])
    port = (tref.nl_ratio if module == "kernels.ref"
            else tni.nonlinearity_ratio)
    _same_bits(port(torch.from_numpy(p)), jax.jit(jnl)(p), "nl_ratio")


def test_sa_sigma_is_reference():
    from repro.core import nonideal as jni
    from repro.core.macro import DEFAULT_MACRO as JMACRO
    from repro.device.analytic import ANALYTIC_DEVICE as JDEV
    from repro_torch.device.analytic import ANALYTIC_DEVICE as TDEV
    p = np.arange(0, 1200, dtype=np.float32)
    _same_bits(TDEV.sa_offset_sigma(torch.from_numpy(p), TMACRO, 1.5),
               jax.jit(lambda q: JDEV.sa_offset_sigma(q, JMACRO, 1.5))(p),
               "sa_offset_sigma")
    _same_bits(tni.sa_required_diff(torch.from_numpy(p), TMACRO),
               jax.jit(lambda q: jni.sa_required_diff(q, JMACRO))(p),
               "sa_required_diff")


@pytest.mark.parametrize("nb", BLOCKS)
def test_ir_drop_factors_are_reference(nb):
    from repro.core import nonideal as jni
    bl = (_rng(nb, 9).random((2, B, nb, N)) * 20).astype(np.float32)
    _same_bits(tni.ir_drop_factors(torch.from_numpy(bl), ALPHA, axis=-2),
               jax.jit(lambda b: jni.ir_drop_factors(b, ALPHA, axis=-2))(bl),
               "ir_drop_factors (min-matrix einsum)")


@pytest.mark.parametrize("nb", BLOCKS)
@pytest.mark.parametrize("ir", [False, True])
def test_line_current_is_reference(nb, ir):
    """The kernel oracle's IR-drop chain: block dot, suffix scan, prefix
    scan, factors and weighted block sum."""
    from repro.kernels import ref as jref
    rng = _rng(nb, 10)
    R = nb * 32 - 4
    x = (rng.random((B, R)) < 0.4).astype(np.float32)
    e = (rng.random((R, N)) * 1.5).astype(np.float32)
    p = jref.IrcEpilogueParams(apply_ir=ir)
    ref = jax.jit(lambda a, b: jref._line_current(a, b, p))(x, e)
    port = tref._line_current(torch.from_numpy(x), torch.from_numpy(e),
                              tref.IrcEpilogueParams(apply_ir=ir))
    _same_bits(port, ref, f"_line_current (apply_ir={ir})")


def _mvm_operands(C, R, seed):
    rng = _rng(R, seed)
    x = (rng.random((C, B, R)) < 0.3).astype(np.float32)
    gp = (rng.random((R, N)) < 0.3).astype(np.float32)
    gn = ((rng.random((R, N)) < 0.3) * (1 - gp)).astype(np.float32)
    lrs = lambda g: (g * np.exp(0.1 * rng.standard_normal((C, R, N)))
                     + (1 - g) * 1e-4).astype(np.float32)
    rnd = (rng.random((C, B, N)) < 0.5).astype(np.float32)
    return x, lrs(gp), lrs(gn), gp, gn, rnd


EFFECTS = [dict(zip(("apply_nonlinearity", "apply_ir", "apply_sa",
                     "apply_range"), bits))
           for bits in itertools.product([False, True], repeat=4)]


@pytest.mark.parametrize("effects", EFFECTS,
                         ids=lambda e: "".join("NISR"[i] if v else "-"
                                               for i, v in
                                               enumerate(e.values())))
def test_irc_mvm_oracle_is_reference(effects):
    """`irc_mvm_chips_ref` at 572 rows (18 blocks), 2 chips: the analog
    difference bit for bit, and the SA decisions bit for bit where the
    offsets put every decision at a near-tie (eps = -diff / sigma, nudged
    by a few ulps), so that any other rounding of the SA input shows."""
    from repro.kernels import ref as jref
    T = torch.from_numpy
    x, ep, en, gp, gn, rnd = _mvm_operands(2, 572, 12)
    jit = lambda p: jax.jit(
        lambda *a: jref.irc_mvm_chips_ref(*a, p))
    pd = tref.IrcEpilogueParams(output="diff", sa_extra=1.5, **effects)
    diff = tref.irc_mvm_chips_ref(T(x), T(ep), T(en), T(gp), T(gn), T(rnd),
                                  T(rnd), pd)
    ref_diff = jit(jref.IrcEpilogueParams(output="diff", sa_extra=1.5,
                                          **effects))(
        x, ep, en, gp, gn, rnd, rnd)
    _same_bits(diff, ref_diff, "irc_mvm_chips_ref output='diff'")
    pp = (T(x) @ T(gp) + T(x) @ T(gn)).double()
    sigma = 0.5 * (2.0 + 0.012 * pp + 2.2e-5 * pp * pp + 1.5)
    nudge = _rng(13).integers(-3, 4, diff.shape).astype(np.float32) * 6e-8
    eps = ((-diff.double() / sigma).float() * (1 + T(nudge))).numpy()
    out = tref.irc_mvm_chips_ref(
        T(x), T(ep), T(en), T(gp), T(gn), T(eps), T(rnd),
        tref.IrcEpilogueParams(sa_extra=1.5, **effects))
    ref = jit(jref.IrcEpilogueParams(sa_extra=1.5, **effects))(
        x, ep, en, gp, gn, eps, rnd)
    _same_bits(out, ref, "irc_mvm_chips_ref SA decisions at near-ties")


@pytest.mark.parametrize("nb", BLOCKS)
@pytest.mark.parametrize("ir,nl", list(itertools.product([0, 1], [0, 1])))
def test_single_shot_accumulate_is_reference(nb, ir, nl):
    """The plain ensemble route's single-shot accumulation: line current
    and count sum."""
    from repro.core import crossbar as jcb
    from repro.core import nonideal as jni
    from repro.core.macro import DEFAULT_MACRO as JMACRO
    rng = _rng(nb, 14)
    bl = (rng.random((2, B, nb, N)) * 20).astype(np.float32)
    counts = np.floor(rng.random((B, nb, N)) * 12).astype(np.float32)
    jc = jni.NonidealConfig(ir_drop=bool(ir), nonlinearity=bool(nl))
    ref = jax.jit(lambda b, c: jcb._accumulate(b, c, jc, JMACRO,
                                               "single_shot", 256))(bl,
                                                                    counts)
    port = tcb._accumulate(torch.from_numpy(bl), torch.from_numpy(counts),
                           tni.NonidealConfig(ir_drop=bool(ir),
                                              nonlinearity=bool(nl)),
                           TMACRO, "single_shot", 256)
    _same_bits(port[0], ref[0], "single-shot line current")
    _same_bits(port[1], ref[1], "p_total (count sum)")


@pytest.mark.parametrize("ir,nl", list(itertools.product([0, 1], [0, 1])))
def test_partial_sum_accumulate_is_reference(ir, nl):
    """Partial sums of 6 blocks (212 rows) over 18 blocks, the chunking
    that needs no padding: chunk sums, per-chunk nonlinearity and the sum
    over chunks."""
    from repro.core import crossbar as jcb
    from repro.core import nonideal as jni
    from repro.core.macro import DEFAULT_MACRO as JMACRO
    rng = _rng(15, ir, nl)
    bl = (rng.random((2, B, 18, N)) * 20).astype(np.float32)
    counts = np.floor(rng.random((2, B, 18, N)) * 12).astype(np.float32)
    jc = jni.NonidealConfig(ir_drop=bool(ir), nonlinearity=bool(nl))
    ref = jax.jit(lambda b, c: jcb._accumulate(b, c, jc, JMACRO,
                                               "partial_sum", 212))(bl,
                                                                    counts)
    port = tcb._accumulate(torch.from_numpy(bl), torch.from_numpy(counts),
                           tni.NonidealConfig(ir_drop=bool(ir),
                                              nonlinearity=bool(nl)),
                           TMACRO, "partial_sum", 212)
    _same_bits(port[0], ref[0], "partial-sum line current")
    _same_bits(port[1], ref[1], "p_total (count sum)")


def test_smoke_detector_at_572_rows_matches_reference():
    """Two stages, 4 chips x 2 images, all effects, 32 bias rows (R = 572,
    the full width's 18 IR blocks): the head against the reference's
    kernel-oracle route.  The dies' planes carry ~1% last-bit differences
    from the normals (`tests/test_torch_prng.py`), so the bar is 1e-6 on
    every element, not identical bits; it holds while no SA decision
    flips."""
    from repro.configs import yolo_irc as jcfg
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import (_sampled_chunk_forward,
                                      detector_planes as jplanes)
    from repro.models import IRCDetector as JDet
    from repro_torch.configs import yolo_irc as tcfg
    from repro_torch.convert import params_from_jax
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc import detector_mc as tmc
    from repro_torch.models.detector import IRCDetector
    jdet = JDet(dataclasses.replace(jcfg.smoke("ternary"), bias_rows=32))
    det = IRCDetector(dataclasses.replace(tcfg.smoke(), bias_rows=32))
    jp = jdet.calibrate_bn(jdet.init(jax.random.PRNGKey(0)),
                           jax.random.uniform(jax.random.PRNGKey(1),
                                              (4, 32, 32, 3)))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    assert det.group_mappings(tp["s0b0"], 60, 60)[0].rows == 572
    ev = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                stride=det.cfg.strides,
                                n_classes=det.cfg.n_classes,
                                n_anchors=det.cfg.n_anchors
                                ).batch_for_step(1000, 2)
    planes, meta = jplanes(jdet, jp)
    ref = np.asarray(_sampled_chunk_forward(
        jp, jnp.asarray(ev.images), jax.random.PRNGKey(5),
        jnp.arange(4, dtype=jnp.uint32), planes, det_cfg=jdet.cfg,
        spec=jdet.spec, cfg_ni=JNI.all(), sa_extra=0.0, meta=meta,
        use_kernel=True, kernel_impl="ref"))
    tpl, tmeta = tmc.detector_planes(det, tp)
    out = tmc._sample_and_forward(
        tp, torch.from_numpy(ev.images), prng.PRNGKey(5, device="cpu"),
        torch.arange(4), tpl, det_cfg=det.cfg, spec=det.spec,
        cfg_ni=tni.NonidealConfig.all(), sa_extra=0.0, meta=tmeta).numpy()
    assert out.shape == ref.shape == (4, 2) + det.head_geometry()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
