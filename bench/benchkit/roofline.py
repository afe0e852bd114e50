"""The yardstick's arithmetic: one H100's published peaks, the least time
of a K1 launch from its shapes, and a model's multiply-accumulates.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its 700 W limit.  A roofline share is the least time over the measured
device time; it cannot pass 100% unless the work is counted too high or
the time leaves part of it out.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

#: bytes/s of HBM3
PEAK_BYTES_PER_S = 3.35e12
#: dense bf16 tensor-core FLOP/s (also the MFU's denominator)
PEAK_BF16_FLOPS = 989e12
#: dense int8 tensor-core OP/s
PEAK_INT8_OPS = 1979e12


def k1_least_s(C: int, B: int, R: int, N: int, *, per_chip_x: bool,
               per_chip_g: bool = False) -> Tuple[float, str]:
    """Least time of one K1 launch (chip-batched IRC MVM) and what bounds
    it ("bytes" | "operations").

    Work: the two {0,1} x {0,1} activated-LRS counts x.g+ and x.g- at the
    int8 dense peak (2 C B R N operations each), and the two f32
    block-current products x.e+ and x.e- as three bf16 passes each at the
    bf16 dense peak (an exact split of the f32 plane), so an exact
    tensor-core K1 cannot read over 100%.

    Bytes, each read or written once: word lines x and placement planes
    g+/g- and the fallback bits at one bit an element ({0,1}); the
    conductance planes e+/e-, the SA offsets and the output at 4 bytes."""
    bits = ((C if per_chip_x else 1) * B * R
            + 2 * (C if per_chip_g else 1) * R * N + C * B * N)
    nbytes = bits / 8 + 4 * (2 * C * R * N + C * B * N + C * B * N)
    product = 2 * C * B * R * N
    t_ops = 2 * product / PEAK_INT8_OPS + 2 * 3 * product / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def detector_k1_launches(cfg: Dict, chips: int, images: int
                         ) -> List[Tuple[int, int, int, int, bool]]:
    """(C, B, R, N, per_chip_x) of every K1 launch of one ensemble forward
    of the detector over `chips` dies and `images` images: one launch per
    group of every block, B the im2col rows (images x positions), R the
    bias rows plus 9 x group, N the group; the first block's word lines are
    shared by every die, later ones are per die."""
    H, W = cfg["img_hw"]
    h, w = -(-H // 2), -(-W // 2)
    g = cfg["group"]
    out = []
    first = True
    for s, (ch, nb) in enumerate(zip(cfg["stage_channels"],
                                     cfg["blocks_per_stage"])):
        if s:
            h, w = -(-h // 2), -(-w // 2)
        for _ in range(nb):
            for _ in range(ch // g):
                out.append((chips, images * h * w, cfg["bias_rows"] + 9 * g,
                            g, not first))
            first = False
    return out


def least_s(launches: Iterable[Sequence]) -> float:
    """Summed least time of K1 launches given as (C, B, R, N, per_chip_x)."""
    return sum(k1_least_s(C, B, R, N, per_chip_x=pcx)[0]
               for C, B, R, N, pcx in launches)


def detector_macs(cfg: Dict) -> int:
    """Multiply-accumulates of one image through the detector at its
    shapes: the 3x3 stride-2 stem, every 3x3 group convolution (9 x group
    inputs an output), and the head's 1x1 projection."""
    H, W = cfg["img_hw"]
    g = cfg["group"]
    h, w = -(-H // 2), -(-W // 2)
    c0 = cfg["stage_channels"][0]
    macs = h * w * c0 * 27
    for s, (ch, nb) in enumerate(zip(cfg["stage_channels"],
                                     cfg["blocks_per_stage"])):
        if s:
            h, w = -(-h // 2), -(-w // 2)
        macs += nb * h * w * ch * 9 * g
    h, w = -(-h // 2), -(-w // 2)
    head_out = cfg["n_anchors"] * (5 + cfg["n_classes"])
    return macs + h * w * cfg["stage_channels"][-1] * head_out


def layer_macs(cfg: Dict) -> int:
    """Multiply-accumulates of one die of the macro layer: every input
    vector of the batch through every mapped row (bias rows included) to
    every output."""
    return cfg["batch"] * (cfg["fan_in"] + cfg["bias_rows"]) * cfg["n_out"]
