"""Detector QAT of the port against the JAX package, on the CPU at the smoke
geometry: the STE quantizers, `yolo_loss`, AdamW and its schedule,
`apply(mode="train")` layer by layer, one QAT step for `train_chips` 1 and 2
(loss and every gradient leaf against `jax.value_and_grad` of the jitted
reference loss), the chip-population keys, the deviation planes, a 3-step
`quick_qat`, and the CLI's `--det-steps` / `--train-chips`.

Tolerances, stated where they are used:
  * bit-identical: the quantizers' forward values and STE gradients, the
    keys, the deviation planes;
  * float32 reordering (rtol 1e-5 or tighter, each test says): sums the
    two packages add in other orders (conv, BN statistics, the loss);
  * the near-tie rule: a binary activation may differ only where the
    reference's pre-activation lies within `NEAR_TIE_TOL` of zero;
  * a whole step and three steps of training: relative L2 error per leaf,
    because a near-tie that flips moves the gradient near it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import ternary as tter  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.kernels.ref import NEAR_TIE_TOL  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedule import warmup_step_decay  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.det_loss import yolo_loss  # noqa: E402
from repro_torch.train.det_qat import batch_tensors, quick_qat  # noqa: E402

torch.set_num_threads(2)

SCHEMES = ("ternary", "binary")


@pytest.fixture(scope="module", autouse=True)
def _partitionable():
    """Both packages on the partitionable threefry scheme for this module's
    tests, the earlier settings restored after them (`test_torch_prng.py`
    holds both schemes)."""
    with jax.threefry_partitionable(True), \
            prng.threefry_partitionable(True):
        yield


def _jni(cfg):
    from repro.core import NonidealConfig as JNI
    return JNI(**dataclasses.asdict(cfg))


def _pair(scheme):
    """(reference detector, port detector, reference init params, the
    same params in the port, synthetic data) at the smoke geometry."""
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    jdet = JDet(jcfg.smoke(scheme))
    det = IRCDetector(tcfg.smoke(scheme))
    jp = jdet.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    return jdet, det, jp, tp, data


@pytest.fixture(scope="module", params=SCHEMES)
def pair(request):
    return _pair(request.param)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + ("/" + n if n else ""), v) for k in sorted(tree)
                for n, v in _leaves(tree[k])]
    return [("", tree)]


def _rel_err(got, want):
    """Relative L2 error of one leaf (absolute where the leaf is zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------ quantizers

def _quantizers():
    from repro.core import ternary as jter
    return [
        ("ternary", jter.ternary_quantize, tter.ternary_quantize),
        ("ternary_groups", lambda w: jter.ternary_quantize(w, axis=(0,)),
         lambda w: tter.ternary_quantize(w, axis=(0,))),
        ("binary", jter.binary_quantize, tter.binary_quantize),
        ("activation", jter.binary_activation, tter.binary_activation),
        ("soft_sa", jter.soft_sa_output, tter.soft_sa_output),
    ]


@pytest.mark.parametrize("i", range(5),
                         ids=[q[0] for q in _quantizers()])
@pytest.mark.parametrize("scale", [0.13, 1.0, 2.0])
def test_ste_forward_and_vjp(i, scale):
    """Forward bit-identical; the vjp equals `jax.vjp`'s bit for bit (the
    sigmoid's within 1 float32 ulp)."""
    _, jf, tf = _quantizers()[i]
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((540, 6)) * scale).astype(np.float32)
    w[0, 0], w[1, 0] = 1.0, -1.0          # the clip's ties
    ct = rng.standard_normal(w.shape).astype(np.float32)
    jy, vjp = jax.vjp(jf, jnp.asarray(w))
    (jg,) = vjp(jnp.asarray(ct))
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tf(wt)
    (tg,) = torch.autograd.grad(y, wt, torch.from_numpy(ct))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    if _quantizers()[i][0] == "soft_sa":
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-7,
                                   atol=1e-12)
    else:
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_ternary_ste_value_off_one():
    """The STE's forward value is soft + (hard - soft) in float32, not
    `hard`: at fan_in=16, n_out=1, seed 33295 the reference gives
    -0.99999994 for a -1, and so does the port."""
    from repro.core import ternary as jter
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(33295), (16, 1)))
    j = np.asarray(jter.ternary_quantize(jnp.asarray(w)))
    t = tter.ternary_quantize(torch.from_numpy(w.copy())).numpy()
    np.testing.assert_array_equal(t, j)
    assert np.float32(-0.99999994) in t


def test_fractions_and_regularizer():
    from repro.core import ternary as jter
    w = np.random.default_rng(3).standard_normal((540, 60)).astype(
        np.float32) * 0.13
    wq = tter.ternary_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(
        tter.ternary_fractions(wq).numpy(),
        np.asarray(jter.ternary_fractions(jter.ternary_quantize(
            jnp.asarray(w)))))
    # two float32 means in other orders: rtol 1e-6
    np.testing.assert_allclose(
        float(tter.distribution_regularizer(torch.from_numpy(w))),
        float(jter.distribution_regularizer(jnp.asarray(w))), rtol=1e-6)


# ------------------------------------------------------------ loss, optimizer

def test_yolo_loss_value_and_grad():
    """Loss and its gradient against `jax.value_and_grad`, rtol 1e-5 (the
    sums over the grid run in other orders); a zero objectness logit takes
    the reference's half gradient of max(x, 0)."""
    from repro.train.det_loss import yolo_loss as jloss
    data = SyntheticDetectionData(img_hw=(64, 96), stride=16, n_classes=3,
                                  n_anchors=5)
    b = data.batch_for_step(0, 3)
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((3, 4, 6, 40)).astype(np.float32)
    pred[0, 0, 0, 4] = 0.0
    jt = {k: jnp.asarray(v) for k, v in b.targets.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jloss(p, jt, 5, 3), has_aux=True)(jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_(True)
    _, tt = batch_tensors(b, torch.device("cpu"))
    tl, taux = yolo_loss(pt, tt, 5, 3)
    (tg,) = torch.autograd.grad(tl, pt)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for k in ("coord", "obj", "cls"):
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(9) * scale).astype(np.float32),
                  "d": np.zeros(3, np.float32)}}


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_one_step(clip):
    """Steps 1-3 (the bias corrections change): where the gradient is not
    clipped (no clip, or a norm under 100) bit-identical to the reference
    called eagerly, each op rounded on its own as the port rounds them;
    where it is clipped (max norm 1) within rtol 1e-5, a few ulps: the
    global norm's sum of squares runs in XLA's reduction order there, and
    the scale's last bit moves the moments, whose update cancels.  The jitted
    reference, which contracts products into fused multiply-adds, within
    rtol 1e-6 throughout."""
    from repro.optim import (AdamWConfig as JCfg, adamw_init as jinit,
                             adamw_update as jupd)
    p = _tree(0)
    jcfg = JCfg(grad_clip=clip, weight_decay=1e-3)
    tcfg_ = tadamw.AdamWConfig(grad_clip=clip, weight_decay=1e-3)
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)
    js = jinit(jax.tree.map(jnp.asarray, p))
    ts = tadamw.adamw_init(t(p))
    jp_, tp_ = jax.tree.map(jnp.asarray, p), t(p)
    lr = np.float32(3e-3)
    for k in range(3):       # steps 1-3: the bias corrections change
        gk = _tree(10 + k, 3.0)
        jnew = jupd(jax.tree.map(jnp.asarray, gk), js, jp_, jnp.float32(lr),
                    jcfg)
        jjit = jax.jit(lambda *a: jupd(*a, jcfg))(
            jax.tree.map(jnp.asarray, gk), js, jp_, jnp.float32(lr))
        tnew = tadamw.adamw_update(t(gk), ts, tp_, torch.tensor(lr), tcfg_)
        exact = (np.testing.assert_array_equal if clip != 1.0 else
                 lambda x, y, err_msg="": np.testing.assert_allclose(
                     x, y, rtol=1e-5, err_msg=err_msg))
        for (name, a), (_, b_), (_, c) in zip(
                _leaves(jax.device_get(jnew[0])), _leaves(_np(tnew[0])),
                _leaves(jax.device_get(jjit[0]))):
            exact(b_, a, err_msg=name)
            np.testing.assert_allclose(b_, c, rtol=1e-6, err_msg=name)
        for part in ("m", "v"):
            for (_, a), (_, b_) in zip(_leaves(jax.device_get(jnew[1][part])),
                                       _leaves(_np(tnew[1][part]))):
                exact(b_, a)
        assert int(tnew[1]["step"]) == int(jnew[1]["step"]) == k + 1
        assert float(tnew[2]["grad_norm"]) == pytest.approx(
            float(jnew[2]["grad_norm"]), rel=1e-6)
        js, jp_ = jnew[1], jnew[0]
        ts, tp_ = tnew[1], tnew[0]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_warmup_step_decay():
    """Bit-identical to the reference's schedule called eagerly, at the
    warm-up, its end and both decay points."""
    from repro.optim import warmup_step_decay as jsched
    for step in (0, 1, 250, 499, 500, 7999, 8000, 10999, 11000, 20000):
        assert float(warmup_step_decay(step)) == float(jsched(step)), step
    assert float(warmup_step_decay(3, 1e-3, 0.0, 4, ())) == float(
        jsched(3, 1e-3, 0.0, 4, ()))


# ------------------------------------------------------------ train mode

def _record(monkeypatch, module):
    """Record every input of `module.binary_activation` (the stem's and
    each block's pre-activation) in a list."""
    log = []
    orig = module.binary_activation

    def rec(x):
        log.append(x)
        return orig(x)

    monkeypatch.setattr(module, "binary_activation", rec)
    return log


@pytest.mark.parametrize("noise", [False, True], ids=["none", "all"])
def test_train_mode_layer_by_layer(pair, noise, monkeypatch):
    """`apply(mode="train")` against the jitted reference: the stem's
    pre-activation within rtol 1e-5 (batch statistics summed in other
    orders), then every block fed the reference's input: its binary
    activations equal the reference's except at near-ties, its
    pre-activations within 1e-4 where they agree (the noise draw is the
    reference's bit for bit, its std within float32 reordering)."""
    import repro.models.detector as jmod
    import repro_torch.models.detector as tmod
    jdet, det, jp, tp, data = pair
    cfg = NonidealConfig.all() if noise else NonidealConfig.none()
    images = data.batch_for_step(0, 4).images
    ins = []
    orig_gconv = jdet._gconv

    def gconv(blk, x, *a, **kw):
        ins.append(x)
        return orig_gconv(blk, x, *a, **kw)

    monkeypatch.setattr(jdet, "_gconv", gconv)
    jlog = _record(monkeypatch, jmod)

    def ref(p, im, k):
        del jlog[:], ins[:]
        out = jdet.apply(p, im, mode="train", key=k, cfg_ni=_jni(cfg))
        return out, list(jlog), list(ins)

    jout, jpre, jins = jax.jit(ref)(jp, jnp.asarray(images),
                                    jax.random.PRNGKey(3))
    tlog = _record(monkeypatch, tmod)
    key = prng.PRNGKey(3, device="cpu")
    out = det.apply(tp, torch.from_numpy(images), mode="train", key=key,
                    cfg_ni=cfg)
    np.testing.assert_allclose(tlog[0].detach().numpy(), np.asarray(jpre[0]),
                               rtol=1e-5, atol=1e-5)
    flips = []
    for i, (name, layer_id, _, _, ch) in enumerate(det.blocks()):
        del tlog[:]
        x = torch.from_numpy(np.asarray(jins[i]))
        det._gconv_train(tp[name], x, ch, ch, key=prng.fold_in(key, layer_id),
                         cfg_ni=cfg)
        pre_t, pre_j = tlog[0].detach().numpy(), np.asarray(jpre[i + 1])
        diff = (pre_t > 0) != (pre_j > 0)
        assert np.all(np.abs(pre_j[diff]) < NEAR_TIE_TOL), name
        np.testing.assert_allclose(pre_t[~diff], pre_j[~diff], atol=1e-4)
        flips.append(int(diff.sum()))
    print(f"{det.cfg.scheme} noise={noise}: near-tie flips per block "
          f"{flips}; head max |diff| "
          f"{float(np.abs(out.detach().numpy() - np.asarray(jout)).max())}")


def test_unknown_mode_raises(pair):
    _, det, _, tp, data = pair
    with pytest.raises(ValueError, match="unknown mode"):
        det.apply(tp, torch.from_numpy(data.batch_for_step(0, 1).images),
                  mode="qat")


# ------------------------------------------------------------ one QAT step

def _jax_value_and_grad(jdet, train_chips, cfg):
    """`jax.value_and_grad` of the reference step's loss, jitted, as
    `repro.train.steps.make_det_qat_step` builds it."""
    from repro.mc.detector_mc import build_train_ensemble as jbuild
    from repro.train.det_loss import yolo_loss as jloss
    jcfg_ = _jni(cfg)
    na, nc = jdet.cfg.n_anchors, jdet.cfg.n_classes

    def loss_fn(p, images, targets, key, ens_key):
        if train_chips == 1:
            pred = jdet.apply(p, images, mode="train", key=key, cfg_ni=jcfg_)
            return jloss(pred, targets, na, nc)[0]
        ens = jbuild(ens_key, jdet, p, train_chips, cfg=jcfg_)
        pred = jdet.apply(p, images, mode="train_ensemble", key=key,
                          cfg_ni=jcfg_, ensemble=ens)
        pred = pred.reshape((-1,) + pred.shape[2:])
        tiled = jax.tree.map(
            lambda t: jnp.tile(t, (train_chips,) + (1,) * (t.ndim - 1)),
            targets)
        return jloss(pred, tiled, na, nc)[0]

    return jax.jit(jax.value_and_grad(loss_fn))


def _step_inputs(data, dev="cpu"):
    b = data.batch_for_step(0, 2)
    images, targets = batch_tensors(b, torch.device(dev))
    return b, images, targets


#: relative L2 error per gradient leaf of one step (the loss within rtol
#: 1e-5): 1.1e-6 at most at the smoke geometry, where no activation flips;
#: a flip at a near-tie would move the gradient of the pixels near it.
GRAD_RTOL = 1e-5


@pytest.mark.parametrize("train_chips", [1, 2])
def test_qat_step_grads_match_reference(pair, train_chips):
    """One QAT step's loss and every gradient leaf, all effects on, against
    `jax.value_and_grad` of the jitted reference loss; the BN running stats
    get zero gradient on both sides.  Then the whole step (AdamW included)
    against the jitted reference step, per leaf within GRAD_RTOL."""
    from repro.optim import adamw_init as jinit
    from repro.train.steps import (ensemble_key_for_step as jek,
                                   make_det_qat_step as jstep)
    jdet, det, jp, tp, data = pair
    cfg = NonidealConfig.all()
    b, images, targets = _step_inputs(data)
    root_j, root_t = jax.random.PRNGKey(1), prng.PRNGKey(1, device="cpu")
    jkey, jens = jax.random.fold_in(root_j, 0), jek(root_j, 0)
    tkey, tens = prng.fold_in(root_t, 0), tsteps.ensemble_key_for_step(
        root_t, 0)
    jt = {k: jnp.asarray(v) for k, v in b.targets.items()}
    jl, jg = _jax_value_and_grad(jdet, train_chips, cfg)(
        jp, jnp.asarray(b.images), jt, jkey, jens)
    tl, tg = tsteps.make_det_qat_grad(det, train_chips=train_chips,
                                      cfg_ni=cfg)(tp, images, targets, tkey,
                                                  tens)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    errs = {}
    for (name, g_j), (_, g_t) in zip(_leaves(jax.device_get(jg)),
                                     _leaves(_np(tg))):
        if name.endswith(("/mean", "/var")):
            assert not np.any(g_t) and not np.any(np.asarray(g_j)), name
            continue
        errs[name] = _rel_err(g_t, g_j)
    print(f"{det.cfg.scheme} train_chips={train_chips}: loss "
          f"{float(tl):.6f} vs {float(jl):.6f}; grad rel err "
          f"{ {k: f'{v:.1e}' for k, v in errs.items()} }")
    assert max(errs.values()) <= GRAD_RTOL, errs

    lr = np.float32(3e-3)
    jnew, _, jloss_ = jax.jit(jstep(jdet, train_chips=train_chips,
                                    cfg_ni=_jni(cfg)))(
        jp, jinit(jp), jnp.asarray(b.images), jt, jnp.float32(lr), jkey,
        jens)
    tnew, opt, tloss = tsteps.make_det_qat_step(
        det, train_chips=train_chips, cfg_ni=cfg)(
        tp, tadamw.adamw_init(tp), images, targets, torch.tensor(lr), tkey,
        tens)
    assert float(tloss) == pytest.approx(float(jloss_), rel=1e-5)
    assert int(opt["step"]) == 1
    for (name, a), (_, c) in zip(_leaves(jax.device_get(jnew)),
                                 _leaves(_np(tnew))):
        assert _rel_err(c, a) <= GRAD_RTOL, name


def test_train_chips_1_is_the_single_draw_step(pair):
    """The port's own pin: `make_det_qat_step(train_chips=1)`, and so
    `quick_qat`, is exactly the single-draw step written out (autograd of
    the loss through `mode="train"` keyed fold_in(PRNGKey(data_seed), s),
    then AdamW), bit for bit over 3 steps; `ens_key` is not read."""
    _, det, _, _, data = pair
    cfg = NonidealConfig.all()
    dev = torch.device("cpu")
    params = det.init(prng.PRNGKey(0, device=dev), device=dev)
    opt = tadamw.adamw_init(params)
    ocfg = tadamw.AdamWConfig(weight_decay=1e-3)
    for s in range(3):
        images, targets = batch_tensors(data.batch_for_step(s, 2), dev)
        p = tadamw.tree_map(lambda t: t.detach().requires_grad_(True),
                            params)
        pred = det.apply(p, images, mode="train", cfg_ni=cfg,
                         key=prng.fold_in(prng.PRNGKey(1, device=dev), s))
        loss = yolo_loss(pred, targets, det.cfg.n_anchors,
                         det.cfg.n_classes)[0]
        leaves = tadamw.tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gtree = tadamw.tree_unflatten(params, [
            torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)])
        params, opt, _ = tadamw.adamw_update(gtree, opt, params,
                                             torch.tensor(3e-3), ocfg)
    got = quick_qat(det, data, 3, 2, cfg_ni=cfg, device="cpu")
    for (name, a), (_, b_) in zip(_leaves(_np(params)), _leaves(_np(got))):
        np.testing.assert_array_equal(b_, a, err_msg=name)
    step = tsteps.make_det_qat_step(det, cfg_ni=cfg)
    images, targets = batch_tensors(data.batch_for_step(0, 2), dev)
    key = prng.PRNGKey(4, device=dev)
    outs = [step(got, tadamw.adamw_init(got), images, targets,
                 torch.tensor(1e-3), key, prng.PRNGKey(e, device=dev))
            for e in (0, 9)]
    for (_, a), (_, b_) in zip(_leaves(_np(outs[0][0])),
                               _leaves(_np(outs[1][0]))):
        np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("every", [1, 3])
def test_ensemble_keys_match_reference(every):
    """`ensemble_key_for_step` bit for bit, across resample windows."""
    from repro.train.steps import ensemble_key_for_step as jek
    assert tsteps.ENSEMBLE_KEY_STREAM == 0x0E25
    root_j, root_t = jax.random.PRNGKey(7), prng.PRNGKey(7, device="cpu")
    for s in range(8):
        np.testing.assert_array_equal(
            tsteps.ensemble_key_for_step(root_t, s, every).numpy(),
            np.asarray(jek(root_j, s, every)).astype(np.int64))
    with pytest.raises(ValueError):
        tsteps.ensemble_key_for_step(root_t, 0, 0)


# ------------------------------------------------------------ deviation planes

def test_deviation_planes_match_reference(pair):
    """`build_train_ensemble`'s deviation planes equal the jitted
    reference's bit for bit (chips 1 and 4), and are exactly zero without
    device variation."""
    from repro.mc.detector_mc import build_train_ensemble as jbuild
    from repro_torch.mc.detector_mc import build_train_ensemble
    jdet, det, jp, tp, _ = pair
    ids = jnp.asarray([1, 4], dtype=jnp.uint32)
    for cfg in (NonidealConfig.all(), NonidealConfig(sa_variation=True)):
        jens = jax.jit(lambda k, p: jbuild(k, jdet, p, 2, chip_ids=ids,
                                           cfg=_jni(cfg)))(
            jax.random.PRNGKey(3), jp)
        tens = build_train_ensemble(prng.PRNGKey(3, device="cpu"), det, tp,
                                    chip_ids=torch.tensor([1, 4]), cfg=cfg)
        for name, groups in jens.layers.items():
            for jg, tg in zip(groups, tens.layers[name]):
                np.testing.assert_array_equal(tg.ep.numpy(),
                                              np.asarray(jg.ep))
                np.testing.assert_array_equal(tg.en.numpy(),
                                              np.asarray(jg.en))
                if not cfg.device_variation:
                    assert not tg.ep.any() and not tg.en.any()


def test_deviation_diff_is_the_manual_delta():
    """The fused IRC MVM's plain version on deviation planes (every effect
    off, output="diff") is x_ext @ (ep - ep0) - x_ext @ (en - en0) per chip
    within float32 reordering (rtol 1e-5, atol 1e-5: IR-block sums against
    one matmul); signed ep/en."""
    from repro_torch.core.mapping import ternary_planes
    from repro_torch.core.macro import DEFAULT_MACRO
    from repro_torch.mc.engine import ensemble_apply_kernel
    from repro_torch.mc.ensemble import deviation_planes, sample_ensemble
    w = tter.ternary_quantize(torch.from_numpy(
        np.random.default_rng(0).standard_normal((90, 12)).astype(
            np.float32)))
    mapped = ternary_planes(w, bias_rows=8)
    ens = sample_ensemble(prng.PRNGKey(1, device="cpu"), mapped, 3,
                          cfg=NonidealConfig.all())
    dev = deviation_planes(ens)
    assert (dev.ep < 0).any() and (dev.ep > 0).any()
    x = (torch.from_numpy(np.random.default_rng(2).random((5, 90))) > 0.5
         ).float()
    out = ensemble_apply_kernel(dev, x, cfg=NonidealConfig.none(),
                                output="diff")
    leak = DEFAULT_MACRO.hrs_leak
    ep0 = ens.gp + (1 - ens.gp) * leak
    en0 = ens.gn + (1 - ens.gn) * leak
    x_ext = torch.cat([torch.ones(5, 8), x], dim=-1).double()
    want = torch.stack([x_ext @ (ens.ep[c] - ep0).double()
                        - x_ext @ (ens.en[c] - en0).double()
                        for c in range(3)])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_train_ensemble_chip_slice_invariant():
    """Chip c's `mode="train_ensemble"` output depends on its identity
    alone, not on the ensemble's size; another chip differs.  The proposed
    design: the baseline's block BN takes its batch statistics over every
    chip, as the reference's does."""
    from repro_torch.mc.detector_mc import build_train_ensemble
    _, det, _, tp, data = _pair("ternary")
    cfg = NonidealConfig.all()
    images = torch.from_numpy(data.batch_for_step(0, 2).images)
    k_ens, k_step = prng.PRNGKey(3, device="cpu"), prng.PRNGKey(9,
                                                                 device="cpu")
    outs = [det.apply(tp, images, mode="train_ensemble", key=k_step,
                      cfg_ni=cfg, ensemble=build_train_ensemble(
                          k_ens, det, tp, n, cfg=cfg)) for n in (3, 1)]
    assert outs[0].shape[0] == 3 and outs[1].shape[0] == 1
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    assert not torch.equal(outs[0][0], outs[0][1])


# ------------------------------------------------------------ quick_qat

#: relative L2 error per leaf after 3 steps of lr 3e-3 from the same init:
#: 5.8e-7 at most at the smoke geometry (the test prints each), with no
#: activation differing at the trained params.
QAT_RTOL = 1e-5


@pytest.mark.parametrize("train_chips", [1, 2])
def test_quick_qat_matches_reference(pair, train_chips, monkeypatch):
    """3 steps of `quick_qat` from the same seed and root key, all effects
    on: every leaf within QAT_RTOL of the reference's; prints the
    activations that flipped at near-ties on the way."""
    from repro.train.det_qat import quick_qat as jqat
    import repro_torch.models.detector as tmod
    jdet, det, _, _, data = pair
    cfg = NonidealConfig.all()
    common = dict(train_chips=train_chips, resample_every=2)
    jp = jqat(jdet, data, 3, 2, cfg_ni=_jni(cfg), **common)
    tp = quick_qat(det, data, 3, 2, cfg_ni=cfg, device="cpu", **common)
    errs = {name: _rel_err(b_, a) for (name, a), (_, b_) in zip(
        _leaves(jax.device_get(jp)), _leaves(_np(tp)))}
    # near-ties: the trained params through both packages' train forward
    jlog, tlog = [], _record(monkeypatch, tmod)
    images = data.batch_for_step(3, 2).images
    det.apply(params_from_jax(jax.device_get(jp), device="cpu"),
              torch.from_numpy(images), mode="train",
              key=prng.PRNGKey(2, device="cpu"), cfg_ni=cfg)
    jlog = [t.detach().numpy() for t in tlog]
    del tlog[:]
    det.apply(tp, torch.from_numpy(images), mode="train",
              key=prng.PRNGKey(2, device="cpu"), cfg_ni=cfg)
    flips = [int(((a > 0) != (b_.detach().numpy() > 0)).sum())
             for a, b_ in zip(jlog, tlog)]
    print(f"{det.cfg.scheme} train_chips={train_chips}: param rel err "
          f"{ {k: f'{v:.1e}' for k, v in errs.items()} }; activations "
          f"that differ at the trained params (stem, blocks): {flips}")
    assert max(errs.values()) <= QAT_RTOL, errs


# ------------------------------------------------------------ the CLI

def _cli_args(train_chips, json_path, steps=2):
    args = ["--network", "detector", "--chips", "3", "--chunk", "2",
            "--ablation", "all", "--det-steps", str(steps), "--json",
            str(json_path)]
    return args + (["--train-chips", "2"] if train_chips > 1 else [])


@pytest.mark.parametrize("train_chips", [1, 2])
def test_cli_trains_on_the_cpu(tmp_path, train_chips):
    """`--det-steps 2 [--train-chips 2]` trains and sweeps each checkpoint
    on the CPU (plain versions: no kernel launch), reported per checkpoint
    and column."""
    import json
    from repro_torch.launch import mc as cli
    out = tmp_path / "r.json"
    cli.main(_cli_args(train_chips, out) + ["--device", "cpu",
                                            "--run-dir", str(tmp_path)])
    report = json.loads(out.read_text())
    cks = {"qat"} if train_chips == 1 else {"single", "ens2"}
    assert set(report["results"]) == cks
    for ck in cks:
        assert set(report["results"][ck]) == {"ideal", "all"}
        for col in report["results"][ck].values():
            assert np.isfinite(col["per_chip_map50"]).all()
            assert len(col["per_chip_map50"]) == 3
    assert not any(report["qat_kernel_launches"].values())
    with pytest.raises(SystemExit, match="needs --det-steps"):
        cli.main(["--network", "detector", "--train-chips", "2",
                  "--device", "cpu"])


@pytest.mark.parametrize("train_chips", [1, 2])
def test_cli_maps_at_reference_params(tmp_path, train_chips, monkeypatch):
    """The port's CLI sweeping the JAX package's `quick_qat` params (carried
    over by `params_from_jax`) gives the JAX CLI's per-chip mAPs in every
    checkpoint and column, up to 0.02 a chip where a near-tie flips a
    decision (none did at this geometry: see the printed maps).  20 steps,
    so that the maps are not all zero."""
    import json
    from repro.configs import yolo_irc as jcfg
    from repro.core import NonidealConfig as JNI
    from repro.data.detection import SyntheticDetectionData as JData
    from repro.launch import mc as jcli
    from repro.models import IRCDetector as JDet
    from repro.train.det_qat import quick_qat as jqat
    from repro_torch.launch import mc as cli
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    import sys
    steps = 20
    monkeypatch.setattr(sys, "argv", ["repro.launch.mc"] + _cli_args(
        train_chips, jpath, steps) + ["--run-dir", ""])
    jcli.main()
    jdet = JDet(jcfg.smoke("ternary"))
    data = JData(img_hw=jdet.cfg.img_hw, stride=jdet.cfg.strides,
                 n_classes=jdet.cfg.n_classes, n_anchors=jdet.cfg.n_anchors)
    if train_chips == 1:
        jparams = {"qat": jqat(jdet, data, steps, 2, seed=0)}
    else:          # the JAX CLI's pair from root PRNGKey(seed + 1)
        common = dict(seed=0, key=jax.random.PRNGKey(1), cfg_ni=JNI.all())
        jparams = {"single": jqat(jdet, data, steps, 2, train_chips=1,
                                  **common),
                   "ens2": jqat(jdet, data, steps, 2, train_chips=2,
                                **common)}
    monkeypatch.setattr(cli, "_train_checkpoints", lambda *a: {
        ck: params_from_jax(jax.device_get(p), device="cpu")
        for ck, p in jparams.items()})
    cli.main(_cli_args(train_chips, tpath, steps) + [
        "--device", "cpu", "--run-dir", str(tmp_path)])
    jrep = json.loads(jpath.read_text())["results"]
    trep = json.loads(tpath.read_text())["results"]
    assert set(jrep) == set(trep) == set(jparams)
    for ck in jrep:
        for col in ("ideal", "all"):
            j = np.asarray(jrep[ck][col]["per_chip_map50"])
            t = np.asarray(trep[ck][col]["per_chip_map50"])
            print(f"{ck} {col}: port {t.tolist()} JAX {j.tolist()}")
            np.testing.assert_allclose(t, j, atol=0.02)


# ------------------------------------------------------------ layer surrogate

def test_variation_noise_std():
    """`variation_noise_std` against the reference's, jitted (its cell
    variance a constant), within 1 float32 ulp (rtol 2.4e-7)."""
    from repro.core.crossbar import variation_noise_std as jstd
    from repro_torch.core.crossbar import variation_noise_std
    p = np.array([-1.0, 0.0, 0.5, 3.0, 216.0, 540.0], np.float32)
    np.testing.assert_allclose(
        variation_noise_std(torch.from_numpy(p), 0.4245).numpy(),
        np.asarray(jax.jit(lambda q: jstd(q, 0.4245))(jnp.asarray(p))),
        rtol=2.4e-7)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("noise", [False, True], ids=["none", "all"])
@pytest.mark.parametrize("output", ["binary", "diff"])
def test_irc_linear_train(scheme, noise, output):
    """`irc_linear_train` (jitted reference, same key): the output and the
    gradients of x and w within rtol 1e-5 (the matmul and the LRS fraction
    sum in other orders); the SA surrogate's binary output equal except at
    near-ties of the pre-activation."""
    from repro.core.crossbar import irc_linear_train as jtrain
    from repro_torch.core.crossbar import irc_linear_train
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 12)) * 0.1).astype(np.float32)
    cfg = NonidealConfig.all() if noise else NonidealConfig.none()
    kw = dict(scheme=scheme, output=output)

    def jf(x_, w_):
        return jtrain(jax.random.PRNGKey(6), x_, w_, cfg=_jni(cfg), **kw)

    jy, vjp = jax.vjp(jax.jit(jf), jnp.asarray(x), jnp.asarray(w))
    ct = rng.standard_normal(jy.shape).astype(np.float32)
    jgx, jgw = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = irc_linear_train(prng.PRNGKey(6, device="cpu"), xt, wt, cfg=cfg,
                         **kw)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(ct))
    if output == "diff":
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   rtol=1e-5, atol=1e-5)
    else:
        pre = irc_linear_train(prng.PRNGKey(6, device="cpu"), xt, wt,
                               cfg=cfg, output="diff", scheme=scheme)
        diff = (y.detach().numpy() > 0.5) != (np.asarray(jy) > 0.5)
        assert np.all(np.abs(pre.detach().numpy()[diff]) < NEAR_TIE_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)
