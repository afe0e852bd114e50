"""The paper's object detector (Fig. 11): a YOLOv2-style backbone of binary
GROUP convolutions (group size 60) mapped onto IRC macros, in PyTorch.

This slice runs the proposed design (ternary weights, no BN, single-shot
accumulation, extra bias rows) in two modes:
  * mode="eval": single-chip structural crossbar sim per group (chip
    identity = `key`), through `crossbar_forward`;
  * mode="ensemble": every chip of a pre-sampled `DetectorEnsemble` at once,
    each group conv as one launch of the fused IRC MVM kernel.
The stem and head are digital (`F.conv2d` / `matmul`, TF32 off).  Every
public function keeps the reference's NHWC layout; params keep its layout
too (stem HWIO, block weights [540, group, n_groups]).  QAT modes and the
baseline design come in later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.crossbar import crossbar_forward
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import MappedLayer, ternary_planes
from repro_torch.core.ternary import ternary_quantize, binary_activation
from repro_torch.runtime import DeviceLike, resolve_device

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detector geometry and design (the reference's `DetectorConfig`)."""
    img_hw: Tuple[int, int] = (576, 1024)     # paper: 1024x576 (w x h)
    n_classes: int = 3                        # IVS 3cls
    n_anchors: int = 5
    group: int = 60                           # paper's group size
    stage_channels: Tuple[int, ...] = (60, 120, 240, 480)
    blocks_per_stage: Tuple[int, ...] = (1, 2, 2, 2)
    scheme: str = "ternary"                   # proposed | "binary" baseline
    use_bn: bool = False                      # baseline: in-memory BN
    accumulation: str = "single_shot"         # baseline: "partial_sum"
    bias_rows: int = 32
    partial_rows: int = 212

    def __post_init__(self):
        # the key lattice layer_id = s*10 + b is injective only while every
        # stage has fewer than 10 blocks
        if any(nb >= 10 for nb in self.blocks_per_stage):
            raise ValueError(
                f"blocks_per_stage {self.blocks_per_stage} breaks the "
                f"s*10+b layer_id key lattice (needs every stage < 10 "
                f"blocks)")
        if len(self.blocks_per_stage) != len(self.stage_channels):
            raise ValueError(
                f"blocks_per_stage {self.blocks_per_stage} and "
                f"stage_channels {self.stage_channels} must align")

    @property
    def strides(self) -> int:
        """Total downsampling: the stem's /2 and one /2 pool per stage."""
        return 2 ** (len(self.stage_channels) + 1)


def _require_proposed(cfg: DetectorConfig) -> None:
    if (cfg.scheme != "ternary" or cfg.use_bn
            or cfg.accumulation != "single_shot"):
        raise NotImplementedError(
            "this slice runs the proposed design (ternary, no BN, "
            "single-shot); the baseline design comes with its own slice")


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _stem_conv(images: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 "SAME" conv, NHWC in and out, HWIO weights."""
    x = images.float().permute(0, 3, 1, 2)
    ph = _same_pads(x.shape[2], 3, 2)
    pw = _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=2)
    return y.permute(0, 2, 3, 1)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over the (H, W) axes of [..., H, W, C] with
    "SAME" (-inf) padding at the far edges, as `reduce_window` does."""
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    y = x.reshape((-1, H, W, C)).permute(0, 3, 1, 2)
    y = F.max_pool2d(y, 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1).reshape(lead + y.shape[2:] + (C,))


class IRCDetector:
    """init/apply for the detector; `apply` returns raw head predictions
    [B, gh, gw, A*(5+C)] (mode="eval") or [chips, B, gh, gw, A*(5+C)]
    (mode="ensemble")."""

    def __init__(self, cfg: DetectorConfig, spec: MacroSpec = DEFAULT_MACRO):
        self.cfg = cfg
        self.spec = spec

    def head_geometry(self) -> Tuple[int, int, int]:
        """(gh, gw, head_out) of `apply`'s raw predictions."""
        cfg = self.cfg
        return (cfg.img_hw[0] // cfg.strides, cfg.img_hw[1] // cfg.strides,
                cfg.n_anchors * (5 + cfg.n_classes))

    def blocks(self):
        """(name, layer_id, stage, cin_declared, cout) of every IRC block in
        forward order; layer_id = s*10 + b keys the block's chips."""
        cfg = self.cfg
        out = []
        for s, (ch, nb) in enumerate(zip(cfg.stage_channels,
                                         cfg.blocks_per_stage)):
            c_in = cfg.stage_channels[max(0, s - 1)] if s else ch
            for b in range(nb):
                out.append((f"s{s}b{b}", s * 10 + b, s,
                            c_in if b == 0 else ch, ch))
        return out

    # ------------------------------------------------------------ params
    def param_shapes(self) -> Dict[str, object]:
        """Parameter tree of (shape, init) leaves, the reference's layout."""
        cfg = self.cfg
        c0 = cfg.stage_channels[0]
        out: Dict[str, object] = {
            "stem": ((3, 3, 3, c0), "normal"),
            "stem_bn": {"gamma": ((c0,), "ones"), "beta": ((c0,), "zeros"),
                        "mean": ((c0,), "zeros"), "var": ((c0,), "ones")},
        }
        for name, _, _, cin, ch in self.blocks():
            out[name] = {"w": ((9 * cfg.group, cfg.group,
                                max(cin, ch) // cfg.group), "normal")}
        head_out = cfg.n_anchors * (5 + cfg.n_classes)
        out["head"] = ((cfg.stage_channels[-1], head_out), "normal")
        out["head_b"] = ((head_out,), "zeros")
        return out

    def init(self, generator: torch.Generator, device: DeviceLike = "cuda"
             ) -> Params:
        """Random parameters from a seeded CPU `torch.Generator`: Gaussian
        weights scaled by 1/sqrt(shape[-2]) (the reference's fan-in rule),
        unit/zero BN; leaves are drawn in sorted-key order, then moved to
        `device`."""
        dev = resolve_device(device)

        def make(tree):
            if isinstance(tree, dict):
                return {k: make(tree[k]) for k in sorted(tree)}
            shape, kind = tree
            if kind == "zeros":
                t = torch.zeros(shape)
            elif kind == "ones":
                t = torch.ones(shape)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                t = torch.randn(shape, generator=generator) / math.sqrt(
                    max(fan_in, 1))
            return t.float().to(dev)

        return make(self.param_shapes())

    # ------------------------------------------------------------ blocks
    def _gconv_weights(self, blk, cin: int, cout: int) -> torch.Tensor:
        """Latent [540, group, n_groups] -> quantized [3, 3, g, g, ng]."""
        cfg = self.cfg
        _require_proposed(cfg)
        wq = ternary_quantize(blk["w"], axis=(0, 1))
        return wq.reshape(3, 3, cfg.group, cfg.group, cout // cfg.group)

    def group_mappings(self, blk, cin: int, cout: int) -> List[MappedLayer]:
        """Per-group `MappedLayer`s of one block: im2col rows are
        spatial-major (9, group), then the bias rows."""
        cfg = self.cfg
        n_groups = cout // cfg.group
        wq = self._gconv_weights(blk, cin, cout).reshape(
            9, cfg.group, cfg.group, n_groups)
        return [ternary_planes(wq[..., g].reshape(9 * cfg.group, cfg.group),
                               bias_rows=cfg.bias_rows)
                for g in range(n_groups)]

    def _im2col_groups(self, x: torch.Tensor, cin: int, n_groups: int
                       ) -> torch.Tensor:
        """[..., H, W, cin] {0,1} -> [..., H, W, n_groups, 9*group].

        `F.unfold` gives the channel-major (cin, 9) patch order of the
        reference's `conv_general_dilated_patches`; rows are then regrouped
        spatial-major per group, (9, group), to match `group_mappings`."""
        cfg = self.cfg
        lead = x.shape[:-3]
        H, W = x.shape[-3:-1]
        flat = x.reshape((-1, H, W, cin)).permute(0, 3, 1, 2)
        patches = F.unfold(flat, 3, padding=1)           # [N, cin*9, H*W]
        patches = patches.transpose(1, 2).reshape(
            lead + (H, W, n_groups, cfg.group, 9))
        return patches.transpose(-1, -2).reshape(
            lead + (H, W, n_groups, 9 * cfg.group))

    def _gconv_structural(self, blk, x: torch.Tensor, cin: int, cout: int,
                          *, key: torch.Tensor, cfg_ni: ni.NonidealConfig,
                          sa_extra: float = 0.0, device=None) -> torch.Tensor:
        """Single-chip crossbar sim: im2col per group -> planes -> SA bits."""
        cfg = self.cfg
        n_groups = cout // cfg.group
        B, H, W, _ = x.shape
        xg = self._im2col_groups(x, cin, n_groups)
        outs = []
        for g, mapped in enumerate(self.group_mappings(blk, cin, cout)):
            out = crossbar_forward(prng.fold_in(key, g),
                                   xg[..., g, :].reshape(B * H * W, -1),
                                   mapped, cfg=cfg_ni, spec=self.spec,
                                   accumulation=cfg.accumulation,
                                   partial_rows=cfg.partial_rows,
                                   sa_extra_units=sa_extra, device=device)
            outs.append(out.reshape(B, H, W, cfg.group))
        return torch.cat(outs, dim=-1)

    def _gconv_ensemble(self, groups, x: torch.Tensor, cin: int, cout: int,
                        *, cfg_ni: ni.NonidealConfig, sa_extra: float = 0.0,
                        output: str = "binary", kernel_impl: str = "kernel",
                        device=None) -> torch.Tensor:
        """Ensemble group conv: each group is ONE launch of the fused IRC
        MVM over every chip (`ensemble_apply_kernel`).

        x is [B,H,W,cin] (chip-shared: the first IRC layer) or
        [chips,B,H,W,cin]; returns [chips,B,H,W,cout].  `kernel_impl="ref"`
        routes through the kernel's plain version instead, on any device."""
        from repro_torch.mc.engine import ensemble_apply_kernel
        cfg = self.cfg
        _require_proposed(cfg)
        n_groups = cout // cfg.group
        per_chip = x.ndim == 5
        B, H, W = x.shape[-4], x.shape[-3], x.shape[-2]
        xg = self._im2col_groups(x, cin, n_groups)
        del x
        outs = []
        for g, ens in enumerate(groups):
            x_bits = xg[..., g, :].reshape(
                (xg.shape[0], -1, 9 * cfg.group) if per_chip
                else (-1, 9 * cfg.group))
            out = ensemble_apply_kernel(ens, x_bits, cfg=cfg_ni,
                                        spec=self.spec,
                                        sa_extra_units=sa_extra,
                                        output=output, per_chip_x=per_chip,
                                        impl=kernel_impl, device=device)
            del x_bits
            outs.append(out.reshape(out.shape[0], B, H, W, cfg.group))
        del xg
        return torch.cat(outs, dim=-1)

    # ------------------------------------------------------------ BN calib
    def calibrate_bn(self, params: Params, images: torch.Tensor) -> Params:
        """Stem BN running stats (population mean/var) from a calibration
        batch; eval and ensemble modes normalize with them."""
        _require_proposed(self.cfg)
        params = dict(params)
        x = _stem_conv(images, params["stem"])
        bn = dict(params["stem_bn"])
        bn["mean"] = torch.mean(x, dim=(0, 1, 2))
        bn["var"] = torch.var(x, dim=(0, 1, 2), unbiased=False)
        params["stem_bn"] = bn
        return params

    # ------------------------------------------------------------ forward
    def apply(self, params: Params, images: torch.Tensor, *,
              mode: str = "eval", key: Optional[torch.Tensor] = None,
              cfg_ni: ni.NonidealConfig = ni.NonidealConfig.none(),
              sa_extra: float = 0.0, ensemble=None,
              kernel_impl: str = "kernel", device=None) -> torch.Tensor:
        """images [B,H,W,3] in [0,1] -> head predictions.

        mode="eval": one chip (identity `key`, default PRNGKey(0) on the
        images' device) -> [B,gh,gw,A*(5+C)]; mode="ensemble": every chip of
        `ensemble` (a `DetectorEnsemble`) -> [chips,B,gh,gw,A*(5+C)], chip c
        matching mode="eval" with key fold_in(base_key, c) up to float32
        near-ties.  `device` is the device model (None: analytic)."""
        cfg = self.cfg
        _require_proposed(cfg)
        if mode not in ("eval", "ensemble"):
            raise NotImplementedError(
                f"mode={mode!r} comes with the QAT slice")
        if key is None:
            key = prng.PRNGKey(0, device=images.device)
        x = _stem_conv(images, params["stem"])
        bn = params["stem_bn"]
        x = bn["gamma"] * (x - bn["mean"]) / torch.sqrt(bn["var"] + 1e-5) \
            + bn["beta"]
        x = binary_activation(x)
        last_stage = 0
        for name, layer_id, s, cin, ch in self.blocks():
            if s != last_stage:
                x = _max_pool_same(x)
                last_stage = s
            if cin < ch:   # widen by repetition before the block
                x = torch.cat([x] * (ch // cin), dim=-1)
                cin = ch
            if mode == "ensemble":
                x = self._gconv_ensemble(
                    ensemble.layers[name], x, cin, ch, cfg_ni=cfg_ni,
                    sa_extra=sa_extra, kernel_impl=kernel_impl, device=device)
            else:
                x = self._gconv_structural(
                    params[name], x, cin, ch,
                    key=prng.fold_in(key, layer_id), cfg_ni=cfg_ni,
                    sa_extra=sa_extra, device=device)
        x = _max_pool_same(x)
        return x @ params["head"] + params["head_b"]
