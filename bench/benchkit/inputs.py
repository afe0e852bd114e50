"""Inputs and weights made from `--seed`, the same for the program and the
reference.

Scenes are a frozen copy of the program's synthetic IVS-3cls renderer
(`data/detection.py::render_batch`): 1-6 axis-aligned objects of three
classes (filled rectangles, outlined rectangles, blobs) on noise, from
NumPy's generator seeded (seed, stream).  Weights are drawn on the device
by one `torch.Generator` seeded with the seed, in one call, and cut into
the program's parameter layout.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _draw_object(img: np.ndarray, cls: int, box, rng) -> None:
    H, W, _ = img.shape
    cx, cy, w, h = box
    x0, x1 = int((cx - w / 2) * W), int((cx + w / 2) * W)
    y0, y1 = int((cy - h / 2) * H), int((cy + h / 2) * H)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, W), min(y1, H)
    color = rng.random(3) * 0.5 + 0.5
    if cls == 0:      # "vehicle": filled rectangle
        img[y0:y1, x0:x1] = color
    elif cls == 1:    # "bike": outlined rectangle
        t = max(1, (y1 - y0) // 6)
        img[y0:y0 + t, x0:x1] = color
        img[y1 - t:y1, x0:x1] = color
        img[y0:y1, x0:x0 + t] = color
        img[y0:y1, x1 - t:x1] = color
    else:             # "pedestrian": bright vertical blob
        xm = (x0 + x1) // 2
        t = max(1, (x1 - x0) // 3)
        img[y0:y1, max(xm - t, 0):min(xm + t, W)] = color


def render_scenes(img_hw: Tuple[int, int], batch: int, n_classes: int,
                  seed: Tuple[int, ...]
                  ) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """`batch` scenes [B, H, W, 3] float32 in [0, 1] with their boxes
    (cx, cy, w, h fractions) and classes, from NumPy's generator at
    `seed`."""
    H, W = img_hw
    rng = np.random.default_rng(seed)
    images = rng.random((batch, H, W, 3)).astype(np.float32) * 0.15
    all_boxes, all_classes = [], []
    for b in range(batch):
        boxes, classes = [], []
        for _ in range(rng.integers(1, 7)):
            w = rng.uniform(0.1, 0.5)
            h = rng.uniform(0.1, 0.5)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            cls = int(rng.integers(0, n_classes))
            _draw_object(images[b], cls, (cx, cy, w, h), rng)
            boxes.append([cx, cy, w, h])
            classes.append(cls)
        all_boxes.append(np.asarray(boxes, np.float32))
        all_classes.append(np.asarray(classes, np.int64))
    return images, all_boxes, all_classes


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A torch generator on `device` seeded with `seed` (any whole number
    below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def detector_weights(cfg: Dict, seed: int, device: torch.device
                     ) -> Dict[str, object]:
    """Random latent weights of the detector in the program's layout, from
    one normal draw on `device` scaled by 1/sqrt(fan_in) per leaf (fan_in
    the leaf's second-to-last axis): stem HWIO [3, 3, 3, c0]; per block
    "w" [9 group, group, max(cin, cout) / group]; head [c_last,
    A(5 + C)]; identity stem BN affine; head bias zero but for each
    anchor's objectness, set to the configuration's prior
    log(p / (1 - p))."""
    g = cfg["group"]
    chans, nbs = cfg["stage_channels"], cfg["blocks_per_stage"]
    head_out = cfg["n_anchors"] * (5 + cfg["n_classes"])
    shapes = [("stem", (3, 3, 3, chans[0]))]
    for s, (ch, nb) in enumerate(zip(chans, nbs)):
        cin = chans[s - 1] if s else ch
        for b in range(nb):
            c_in = cin if b == 0 else ch
            shapes.append((f"s{s}b{b}", (9 * g, g, max(c_in, ch) // g)))
    shapes.append(("head", (chans[-1], head_out)))
    flat = torch.randn(sum(math.prod(s) for _, s in shapes),
                       generator=generator(seed, device), device=device)
    out: Dict[str, object] = {}
    at = 0
    for name, shape in shapes:
        n = math.prod(shape)
        leaf = flat[at:at + n].reshape(shape) / math.sqrt(shape[-2])
        at += n
        out[name] = leaf if name in ("stem", "head") else {"w": leaf}
    c0 = chans[0]
    out["stem_bn"] = {"gamma": torch.ones(c0, device=device),
                      "beta": torch.zeros(c0, device=device)}
    p = float(cfg["objectness_prior"])
    bias = torch.zeros(head_out, device=device)
    bias[4::5 + cfg["n_classes"]] = math.log(p / (1.0 - p))
    out["head_b"] = bias
    return out


def layer_inputs(cfg: Dict, seed: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The macro layer's latent weights [fan_in, n_out] (standard normal)
    and word lines [batch, fan_in], each bit on with the configuration's
    density, from one generator on `device`."""
    g = generator(seed, device)
    w = torch.randn((cfg["fan_in"], cfg["n_out"]), generator=g,
                    device=device)
    u = torch.rand((cfg["batch"], cfg["fan_in"]), generator=g, device=device)
    return w, (u < cfg["density"]).float()
