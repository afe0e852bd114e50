"""Plain reference of the proposed IRC detector (paper Fig. 11, Table II's
proposed design): a digital 3x3 stride-2 stem with batch-norm from the
eval batch's own statistics and a step activation, then 3x3 group
convolutions of group 60 on IRC macros (ternary weights mapped at the
configuration's fractions, 20/60/20, per group, 32 always-on bias rows, single-shot accumulation), a 2x2 max
pool before each later stage and after the last, and a digital head.

Die c's crossbar of block (stage s, block b), group g is sampled from
fold_in(fold_in(fold_in(key, c), 10 s + b), g) (`irc.sample_dies`).  A
group's word lines are its 9 x 60 im2col bits, spatial-major (kernel
position, then channel), after the bias rows; its SA draws are indexed by
(image, row, column) of the whole eval batch, then output.  A stage that
widens repeats its input channels.

`head` gives one die's head outputs [B, gh, gw, A (5 + C)]; `score` its
mAP@0.5.  Matrix products go through `irc.mm`, so precision="tf32" runs
the same reference at TF32's precision (the control).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference import detmap, irc
from reference import threefry as tf

mm = irc.mm


def _conv_stem(images: torch.Tensor, w_hwio: torch.Tensor,
               precision: str) -> torch.Tensor:
    """3x3 stride-2 "SAME" convolution as an im2col product: NHWC [B, H,
    W, 3] -> [B, ceil(H/2), ceil(W/2), c0]."""
    x = images.permute(0, 3, 1, 2)
    H, W = x.shape[2:]
    ph = max((-(-H // 2) - 1) * 2 + 3 - H, 0)
    pw = max((-(-W // 2) - 1) * 2 + 3 - W, 0)
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    cols = F.unfold(x, 3, stride=2)                 # [B, 3*9, L], (ci, kh, kw)
    w = w_hwio.permute(2, 0, 1, 3).reshape(27, -1)  # (ci, kh, kw) x c0
    y = mm(cols.transpose(1, 2), w, precision)      # [B, L, c0]
    return y.reshape(x.shape[0], -(-H // 2), -(-W // 2), -1)


def stem_bits(params: Dict, images: torch.Tensor,
              precision: str = "float32",
              calib: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stem's {0,1} activations [B, h, w, c0], normalised with the
    mean and population variance of the stem's outputs on the calibration
    batch `calib` (default: `images` themselves), the calibrated BN."""
    x = _conv_stem(images.float(), params["stem"], precision)
    c = x if calib is None else _conv_stem(calib.float(), params["stem"],
                                           precision)
    mean = c.mean(dim=(0, 1, 2))
    var = c.var(dim=(0, 1, 2), unbiased=False)
    bn = params["stem_bn"]
    y = bn["gamma"] * (x - mean) / torch.sqrt(var + 1e-5) + bn["beta"]
    return (y > 0).float()


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of NHWC, padding the far edges."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _group_rows(x: torch.Tensor, g: int, group: int) -> torch.Tensor:
    """Group g's im2col word lines of NHWC bits x: [B, H W, 9 group] in
    (kernel position, channel) order."""
    B, H, W, _ = x.shape
    xs = x[..., g * group:(g + 1) * group].permute(0, 3, 1, 2)
    cols = F.unfold(xs, 3, padding=1)                # [B, group*9, HW]
    cols = cols.reshape(B, group, 9, H * W).permute(0, 3, 2, 1)
    return cols.reshape(B, H * W, 9 * group)


def head(params: Dict, cfg: Dict, bits0: torch.Tensor, key: torch.Tensor,
         chip: int, *, effects: irc.Effects, device: irc.Device,
         precision: str = "float32") -> torch.Tensor:
    """Die `chip`'s head outputs [B, gh, gw, A (5 + C)] from the stem's
    bits `bits0` under root key `key` ([2] int64)."""
    macro = irc.Macro.from_config(cfg["macro"])
    group, bias_rows = cfg["group"], cfg["bias_rows"]
    chans, nbs = cfg["stage_channels"], cfg["blocks_per_stage"]
    fractions = irc.scheme(cfg)
    die = tf.fold_in(key, chip)
    x = bits0
    for s, (ch, nb) in enumerate(zip(chans, nbs)):
        if s:
            x = _pool(x)
        for b in range(nb):
            if x.shape[-1] < ch:
                x = torch.cat([x] * (ch // x.shape[-1]), dim=-1)
            w = params[f"s{s}b{b}"]["w"]
            B, H, W, _ = x.shape
            layer_key = tf.fold_in(die, 10 * s + b)
            outs = []
            for g in range(ch // group):
                gp, gn = irc.planes(irc.ternary_map(w[..., g], *fractions),
                                    bias_rows)
                ep, en, k_sa = irc.sample_dies(
                    tf.fold_in(layer_key, g)[None], gp, gn, macro, effects,
                    device)
                rows = _group_rows(x, g, group)
                ones = torch.ones(B, H * W, bias_rows, device=x.device)
                bits = [irc.evaluate(torch.cat([ones[i], rows[i]], -1),
                                     ep[0], en[0], gp, gn, k_sa[0],
                                     i * H * W, macro, effects, precision)
                        for i in range(B)]
                outs.append(torch.stack(bits).reshape(B, H, W, group))
            x = torch.cat(outs, dim=-1)
    x = _pool(x)
    return mm(x, params["head"], precision) + params["head_b"]


def heads(params: Dict, cfg: Dict, images: torch.Tensor, key: torch.Tensor,
          chips: List[int], *, effects: irc.Effects, device: irc.Device,
          precision: str = "float32",
          calib: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Head outputs [len(chips), B, gh, gw, A (5 + C)] of dies `chips`,
    the stem's BN calibrated on `calib` (default: `images`)."""
    with torch.no_grad():
        bits0 = stem_bits(params, images, precision, calib)
        return torch.stack([head(params, cfg, bits0, key, c, effects=effects,
                                 device=device, precision=precision)
                            for c in chips])


def score(preds: np.ndarray, gt_boxes, gt_classes, cfg: Dict) -> float:
    """mAP@0.5 of one die's head outputs."""
    return detmap.map50(preds, gt_boxes, gt_classes, cfg["n_anchors"],
                        cfg["n_classes"])
