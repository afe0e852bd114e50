"""Whole-detector port vs JAX at full width (`yolo_irc.proposed()`,
576x1024 images), on the CPU: 1 chip x 1 image, all effects, the same
params (the reference's, carried over) and the same key.

It reports and asserts:
  * the elementwise agreement of the head predictions end to end, port
    against the reference's kernel-oracle route (`use_kernel=True,
    kernel_impl="ref"`): at least 99% within 1e-4.  It prints the same
    reading between the reference's own two routes (that one and the jnp
    `ensemble_apply` route) and between the port's own two routes
    (ensemble and single-chip eval, whose IR-drop formulations differ);
  * the per-chip mAP@0.5 of each (1.0 on every route at random init with
    one image, so it cannot tell the port from a wrong one);
  * layer by layer, each from the reference's own input: the stem's bits
    (the port's conv, BN and sign against the reference's), each pool, and
    each of the six IRC layers: the outputs that differ (SA decisions for
    the IRC layers), zero at every one; then the head on the reference's
    last bits.
The port's kernel-oracle route adds in the reference's float32 order
(`repro_torch.xla_order`), so a layer fed the reference's bits gives its
bits exactly.

Too heavy for tier-1 (several GiB and minutes): it runs only with
REPRO_TORCH_FULLWIDTH=1,

    REPRO_TORCH_FULLWIDTH=1 PYTHONPATH=src python -m pytest -s \\
        tests/test_torch_detector_fullwidth.py
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.macro import DEFAULT_MACRO  # noqa: E402
from repro_torch.core.mapping import extend_rows  # noqa: E402
from repro_torch.core.nonideal import NonidealConfig  # noqa: E402
from repro_torch.data.detection import SyntheticDetectionData  # noqa: E402
from repro_torch.kernels.ref import (IrcEpilogueParams,  # noqa: E402
                                     irc_mvm_chips_ref, near_tie_flips)
from repro_torch.mc import detector_mc as tmc  # noqa: E402
from repro_torch.mc.engine import periphery_noise  # noqa: E402
from repro_torch.core.ternary import binary_activation  # noqa: E402
from repro_torch.models.detector import (IRCDetector,  # noqa: E402
                                         _max_pool_same, _stem_conv)
from repro_torch.train.det_loss import evaluate_map_per_chip  # noqa: E402

KEY, CHIP = 5, 0


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


@pytest.fixture(scope="module")
def fullwidth():
    """The reference's full-width detector, its params in both packages
    and one synthetic 576x1024 eval image; skips unless opted in."""
    if os.environ.get("REPRO_TORCH_FULLWIDTH") != "1":
        pytest.skip("full width needs several GiB and minutes on the CPU; "
                    "set REPRO_TORCH_FULLWIDTH=1 to run it")
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    torch.set_num_threads(4)
    jdet = JDet(jcfg.proposed())
    det = IRCDetector(tcfg.proposed())
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    jp = jdet.calibrate_bn(jdet.init(jax.random.PRNGKey(0)),
                           jnp.asarray(data.batch_for_step(999, 2).images))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    ev = data.batch_for_step(1000, 1)
    return jdet, jp, det, tp, ev


def _jax_heads(jdet, jp, ev, use_kernel):
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import _sampled_chunk_forward, detector_planes
    planes, meta = detector_planes(jdet, jp)
    return np.asarray(_sampled_chunk_forward(
        jp, jnp.asarray(ev.images), jax.random.PRNGKey(KEY),
        jnp.asarray([CHIP], dtype=jnp.uint32), planes, det_cfg=jdet.cfg,
        spec=jdet.spec, cfg_ni=JNI.all(), sa_extra=0.0, meta=meta,
        use_kernel=use_kernel, kernel_impl="ref"))


def _jax_pool(x):
    wd = (1,) * (x.ndim - 3) + (2, 2, 1)
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, wd, wd, "SAME")


def _margin(det, groups, xt, ch, like):
    """The plain version's decision margin of every output of one layer."""
    xg = det._im2col_groups(xt, ch, len(groups))
    per_chip = xt.ndim == 5
    params = IrcEpilogueParams.from_macro(DEFAULT_MACRO)
    margins = []
    for g, ens in enumerate(groups):
        x = xg[..., g, :].reshape(
            (xg.shape[0], -1, 9 * det.cfg.group) if per_chip
            else (-1, 9 * det.cfg.group))
        x_ext = extend_rows(x, ens.lead_rows)
        eps, rnd = periphery_noise(ens.sa_keys, x_ext.shape[-2], ens.n_out)
        margins.append(irc_mvm_chips_ref(x_ext, ens.ep, ens.en, ens.gp,
                                         ens.gn, eps, rnd, params,
                                         margin=True)[1])
    return torch.cat([m.reshape(like.shape[:-1] + (-1,)) for m in margins],
                     dim=-1)


def _bits_row(name, port, ref):
    """(name, differing outputs, True, outputs) of a layer whose outputs
    must agree exactly."""
    ref = torch.from_numpy(np.array(ref))
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    return name, int((port != ref).sum()), True, port.numel()


def _layer_by_layer(jdet, jp, det, tp, ev):
    """The stem, each pool and each IRC layer on both sides from the
    reference's input, then the head on its last bits: ([(layer, differing
    outputs, all near-ties, outputs)], fraction of head elements within
    1e-4)."""
    from repro.core import NonidealConfig as JNI
    from repro.mc.detector_mc import build_detector_ensemble as jbuild
    cfg = jdet.cfg
    x = jax.lax.conv_general_dilated(
        jnp.asarray(ev.images), jp["stem"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    bn = jp["stem_bn"]
    x = bn["gamma"] * (x - bn["mean"]) / jnp.sqrt(bn["var"] + 1e-5) \
        + bn["beta"]
    x = (x > 0).astype(jnp.float32)
    tbn = tp["stem_bn"]
    ts = _stem_conv(torch.from_numpy(ev.images), tp["stem"])
    ts = binary_activation(tbn["gamma"] * (ts - tbn["mean"])
                           / torch.sqrt(tbn["var"] + 1e-5) + tbn["beta"])
    rows = [_bits_row("stem", ts, x)]
    ids = jnp.asarray([CHIP], dtype=jnp.uint32)
    # jitted, as the reference's sweeps sample (XLA folds the variation
    # sigma into the normal's sqrt(2) there)
    jens = jax.jit(lambda k, p: jbuild(k, jdet, p, chip_ids=ids,
                                       cfg=JNI.all()))(
        jax.random.PRNGKey(KEY), jp)
    cfg_t = NonidealConfig.all()
    tens = tmc.build_detector_ensemble(
        prng.PRNGKey(KEY, device="cpu"), det, tp,
        chip_ids=torch.tensor([CHIP]), cfg=cfg_t)
    last_stage = 0
    for name, _, s, cin, ch in det.blocks():
        if s != last_stage:
            rows.append(_bits_row(f"pool{s}", _max_pool_same(
                torch.from_numpy(np.array(x))), _jax_pool(x)))
            x = _jax_pool(x)
            last_stage = s
        if cin < ch:
            x = jnp.concatenate([x] * (ch // cin), axis=-1)
        j = jdet._gconv_ensemble(jens.layers[name], x, ch, ch,
                                 cfg_ni=JNI.all(), use_kernel=True,
                                 kernel_impl="ref")
        xt = torch.from_numpy(np.array(x))
        t = det._gconv_ensemble(tens.layers[name], xt, ch, ch, cfg_ni=cfg_t)
        margin = _margin(det, tens.layers[name], xt, ch, t)
        n, ok = near_tie_flips(t, torch.from_numpy(np.asarray(j)), margin)
        rows.append((name, n, ok, t.numel()))
        x = j
    rows.append(_bits_row("pool_last", _max_pool_same(
        torch.from_numpy(np.array(x))), _jax_pool(x)))
    x = _jax_pool(x)
    head_j = np.asarray(x @ jp["head"] + jp["head_b"])
    head_t = (torch.from_numpy(np.array(x)) @ tp["head"]
              + tp["head_b"]).numpy()
    return rows, float(np.mean(np.abs(head_t - head_j) <= 1e-4))


def test_port_against_reference_at_full_width(fullwidth):
    jdet, jp, det, tp, ev = fullwidth
    ref = _jax_heads(jdet, jp, ev, use_kernel=True)
    tpl, tmeta = tmc.detector_planes(det, tp)
    out = tmc._sample_and_forward(
        tp, torch.from_numpy(ev.images), prng.PRNGKey(KEY, device="cpu"),
        torch.tensor([CHIP]), tpl, det_cfg=det.cfg, spec=det.spec,
        cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=tmeta).numpy()
    assert out.shape == ref.shape == (1, 1) + det.head_geometry()
    frac = float(np.mean(np.abs(out - ref) <= 1e-4))
    kw = dict(gt_boxes=ev.boxes, gt_classes=ev.classes,
              n_anchors=det.cfg.n_anchors, n_classes=det.cfg.n_classes)
    map_t = evaluate_map_per_chip(out, **kw)
    map_j = evaluate_map_per_chip(ref, **kw)
    jnp_route = _jax_heads(jdet, jp, ev, use_kernel=False)
    frac_jax = float(np.mean(np.abs(jnp_route - ref) <= 1e-4))
    map_jax = evaluate_map_per_chip(jnp_route, **kw)
    single = det.apply(tp, torch.from_numpy(ev.images), mode="eval",
                       key=prng.fold_in(prng.PRNGKey(KEY, device="cpu"),
                                        CHIP),
                       cfg_ni=NonidealConfig.all()).numpy()[None]
    frac_port = float(np.mean(np.abs(single - out) <= 1e-4))
    map_port = evaluate_map_per_chip(single, **kw)
    rows, frac_head = _layer_by_layer(jdet, jp, det, tp, ev)
    layers = "\n".join(
        f"  {name}: {n} of {total} outputs differ, all near-ties: {ok}"
        for name, n, ok, total in rows)
    print(f"\nfull width 576x1024, chip {CHIP}, 1 image, all effects:\n"
          f"  port vs reference (kernel-oracle route): {frac:.6f} of head "
          f"elements within 1e-4; mAP@0.5 {map_t.tolist()} vs "
          f"{map_j.tolist()}\n"
          f"  reference jnp route vs its kernel-oracle route: "
          f"{frac_jax:.6f} within 1e-4; mAP@0.5 {map_jax.tolist()}\n"
          f"  port single-chip eval vs its ensemble route: "
          f"{frac_port:.6f} within 1e-4; mAP@0.5 {map_port.tolist()}\n"
          f"layer by layer, each from the reference's input bits:\n{layers}\n"
          f"  head on the reference's last bits: {frac_head:.6f} of "
          f"elements within 1e-4")
    assert np.isfinite(out).all()
    np.testing.assert_allclose(map_t, map_j, atol=0.02)
    assert [name for name, *_ in rows if name[0] == "s" and name != "stem"
            ] == [b[0] for b in det.blocks()]
    assert all(n == 0 for _, n, _, _ in rows), rows
    assert frac_head >= 0.99
    assert frac >= 0.99
