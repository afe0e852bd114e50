"""The paper's object detector (Fig. 11): a YOLOv2-style backbone of binary
GROUP convolutions (group size 60) mapped onto IRC macros, in PyTorch.

Both Table II designs run: the proposed one (ternary weights, no BN,
single-shot accumulation, extra bias rows) and the baseline (binary weights
against a shared reference line, in-memory BN folded into bias cells,
partial-sum accumulation), in four modes:
  * mode="train": differentiable QAT: STE quantizers, a plain grouped conv,
    batch-statistics BN, and (with effects on) the noise surrogate added to
    each pre-activation, keyed fold_in(key, s*10+b);
  * mode="train_ensemble": ensemble-aware QAT over a deviation population
    (`mc.detector_mc.build_train_ensemble`): each chip's frozen variation
    error from the fused IRC MVM (`output="diff"`, no gradient) plus a fresh
    per-chip SA-offset draw;
  * mode="eval": single-chip structural crossbar sim per group (chip
    identity = `key`), through `crossbar_forward`;
  * mode="ensemble": every chip of a pre-sampled `DetectorEnsemble` at once.
    A single-shot group conv is one launch of the fused IRC MVM kernel, or
    the plain batched `ensemble_apply` where `use_kernel` says so (None:
    the autotuner's table for this card, `repro_torch.kernels.autotune`);
    a partial-sum group conv always takes the plain route, as in the
    reference, whose kernel fuses single-shot accumulation only.
The stem and head are digital (`F.conv2d` / `matmul`, TF32 off).  Every
public function keeps the reference's NHWC layout; params keep its layout
too (stem HWIO, block weights [540, group, n_groups], the baseline's block
BN as `bn` {gamma, beta, mean, var}).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch import xla_order as xo
from repro_torch.core import nonideal as ni
from repro_torch.core.crossbar import (add_noise, crossbar_forward,
                                       variation_noise_std)
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import (MappedLayer, binary_planes,
                                     fold_bn_to_bias_units, ternary_planes)
from repro_torch.core.ternary import (binary_activation, binary_quantize,
                                     ternary_quantize)
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


def _batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor
                ) -> torch.Tensor:
    """The train modes' BN over [N,H,W,C]: batch statistics over (N, H, W)
    (population variance), differentiable through them."""
    mu = torch.mean(x, dim=(0, 1, 2))
    var = torch.var(x, dim=(0, 1, 2), correction=0)
    return gamma * (x - mu) / xo.sqrt(var + 1e-5) + beta


def _grouped_conv(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Ideal 3x3 stride-1 "SAME" group conv, NHWC: x [B,H,W,ng*g] and
    quantized weights [3,3,g,g,ng] (HWIO per group) -> [B,H,W,ng*g]."""
    g, ng = wq.shape[2], wq.shape[4]
    w = wq.permute(4, 3, 2, 0, 1).reshape(ng * g, g, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=ng)
    return y.permute(0, 2, 3, 1)


class IRCDetector:
    """init/apply for the detector; `apply` returns raw head predictions
    [B, gh, gw, A*(5+C)] (modes "train" and "eval") or [chips, B, gh, gw,
    A*(5+C)] (modes "train_ensemble" and "ensemble")."""

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
            if cfg.use_bn:
                out[name]["bn"] = {"gamma": ((ch,), "ones"),
                                   "beta": ((ch,), "zeros"),
                                   "mean": ((ch,), "zeros"),
                                   "var": ((ch,), "ones")}
        head_out = cfg.n_anchors * (5 + cfg.n_classes)
        out["head"] = ((cfg.stage_channels[-1], head_out), "normal")
        out["head_b"] = ((head_out,), "zeros")
        return out

    def init(self, key: torch.Tensor, device: DeviceLike = "cuda"
             ) -> Params:
        """The reference's `init(key)` (`materialize`) from a port PRNG key
        ([2] int64), bit for bit: one key per leaf from `split(key,
        n_leaves)` in `jax.tree.flatten` order (sorted keys, depth first);
        zeros and ones as the leaf says; otherwise `normal(k, shape)` times
        float32(1 / sqrt(fan_in)) as its own rounding (the reference
        multiplies eagerly, after the jitted normal), fan_in being
        shape[-2], or shape[-1] for a vector.  Drawn on `device`."""
        dev = resolve_device(device)
        leaves: List[Tuple[Tuple[str, ...], Tuple[int, ...], str]] = []

        def walk(tree, path):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    walk(tree[k], path + (k,))
            else:
                leaves.append((path,) + tuple(tree))

        walk(self.param_shapes(), ())
        keys = prng.split(key.to(dev), len(leaves))
        out: Params = {}
        for i, (path, shape, kind) in enumerate(leaves):
            if kind == "zeros":
                t = torch.zeros(shape, device=dev)
            elif kind == "ones":
                t = torch.ones(shape, device=dev)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                std = np.float32(1.0 / math.sqrt(max(fan_in, 1)))
                t = prng.normal(keys[i], shape) * torch.tensor(
                    std, device=dev)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        return out

    # ------------------------------------------------------------ blocks
    def _gconv_weights(self, blk, cin: int, cout: int) -> torch.Tensor:
        """Latent [540, group, n_groups] -> quantized [3, 3, g, g, ng]:
        ternary per group (proposed) or sign-binary (baseline)."""
        cfg = self.cfg
        if cfg.scheme == "ternary":
            wq = ternary_quantize(blk["w"], axis=(0, 1))
        else:
            wq = binary_quantize(blk["w"])
        return wq.reshape(3, 3, cfg.group, cfg.group, cout // cfg.group)

    def _gconv_pre(self, blk, x4: torch.Tensor, cin: int, cout: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Differentiable QAT pre-activation of the train modes: quantized
        grouped conv, and for the baseline its block BN on batch statistics
        with |gamma| (the in-memory fold is sign-preserving only for
        positive gamma).  [N,H,W,cin] -> ([N,H,W,cout], quantized kernel
        [3,3,g,g,ng])."""
        wq = self._gconv_weights(blk, cin, cout)
        pre = _grouped_conv(x4, wq)
        if self.cfg.use_bn:
            bn = blk["bn"]
            pre = _batch_norm(pre, bn["gamma"].abs(), bn["beta"])
        return pre, wq

    def _p_pair(self, x: torch.Tensor, wq: torch.Tensor, cin: int
                ) -> torch.Tensor:
        """Expected activated-LRS count on a group's differential pair, from
        the word lines on at each pixel and the quantized weights' LRS
        fraction (ternary ~0.4, binary ~1.0), left to right as the
        reference writes it."""
        lrs_frac = torch.mean(torch.abs(wq.detach()))
        return (torch.sum(x.detach(), dim=-1, keepdim=True) * lrs_frac
                * 9.0 / cin * self.cfg.group)

    def _gconv_train(self, blk, x: torch.Tensor, cin: int, cout: int, *,
                     key: torch.Tensor, cfg_ni: ni.NonidealConfig
                     ) -> torch.Tensor:
        """mode="train" group conv: the pre-activation plus (with device or
        SA variation on) one noise draw `normal(key, pre.shape)` scaled by
        the surrogate std, then the binary activation."""
        pre, wq = self._gconv_pre(blk, x, cin, cout)
        if cfg_ni.device_variation or cfg_ni.sa_variation:
            p_pair = self._p_pair(x, wq, cin)
            std = 0.0
            if cfg_ni.device_variation:
                std = std + variation_noise_std(p_pair, self.spec.sigma_lrs)
            if cfg_ni.sa_variation:
                std = std + 0.5 * ni.sa_required_diff(p_pair, self.spec)
            pre = add_noise(pre, std, prng.normal(key, pre.shape))
        return binary_activation(pre)

    def group_mappings(self, blk, cin: int, cout: int) -> List[MappedLayer]:
        """Per-group `MappedLayer`s of one block: im2col rows are
        spatial-major (9, group), after the scheme's leading rows (the
        proposed design's bias rows; the baseline's in-memory BN rows, its
        block BN folded into bias units with |gamma|, the sign-preserving
        fold)."""
        cfg = self.cfg
        n_groups = cout // cfg.group
        wq = self._gconv_weights(blk, cin, cout).detach().reshape(
            9, cfg.group, cfg.group, n_groups)
        maps = []
        for g in range(n_groups):
            w_flat = wq[..., g].reshape(9 * cfg.group, cfg.group)
            if cfg.scheme == "ternary":
                maps.append(ternary_planes(w_flat, bias_rows=cfg.bias_rows))
                continue
            units = None
            if cfg.use_bn:
                bn = blk["bn"]
                sl = slice(g * cfg.group, (g + 1) * cfg.group)
                units = fold_bn_to_bias_units(
                    bn["gamma"][sl].abs(), bn["beta"][sl], bn["mean"][sl],
                    bn["var"][sl])
            maps.append(binary_planes(w_flat, bn_bias_units=units,
                                      spec=self.spec))
        return maps

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
                        output: str = "binary",
                        use_kernel: Optional[bool] = None,
                        kernel_impl: str = "kernel",
                        device=None) -> torch.Tensor:
        """Ensemble group conv over every chip: per group, one launch of the
        fused IRC MVM (`ensemble_apply_kernel`) or the plain batched route
        (`ensemble_apply`).

        `use_kernel` routes each group, as the reference's does: True forces
        the kernel (single-shot accumulation only: its fused epilogue;
        anything else raises); False forces the plain route; None (default)
        takes the kernel where the accumulation is single-shot, the device
        model's periphery is the analytic one (the epilogue bakes it in)
        and `kernels.autotune.kernel_wins` says so for this problem on the
        tensors' device (an untuned problem runs the kernel).  The kernel
        runs at `autotune.best_blocks`' row tile.  `kernel_impl="ref"`
        routes the kernel's groups through its plain version instead, on
        any device.  Partial sums (the baseline) take the plain route.

        x is [B,H,W,cin] (chip-shared: the first IRC layer) or
        [chips,B,H,W,cin]; returns [chips,B,H,W,cout]."""
        from repro_torch.kernels import autotune
        from repro_torch.mc.engine import ensemble_apply, ensemble_apply_kernel
        cfg = self.cfg
        if kernel_impl not in ("kernel", "ref"):
            raise ValueError(f"kernel_impl must be 'kernel' or 'ref', got "
                             f"{kernel_impl!r}")
        if use_kernel and cfg.accumulation != "single_shot":
            raise ValueError(
                "use_kernel=True requires single_shot accumulation (fused "
                f"kernel epilogue); got {cfg.accumulation!r}")
        n_groups = cout // cfg.group
        per_chip = x.ndim == 5
        B, H, W = x.shape[-4], x.shape[-3], x.shape[-2]
        xg = self._im2col_groups(x, cin, n_groups)
        backend = autotune.backend_of(x.device)
        del x
        outs = []
        for g, ens in enumerate(groups):
            x_bits = xg[..., g, :].reshape(
                (xg.shape[0], -1, 9 * cfg.group) if per_chip
                else (-1, 9 * cfg.group))
            problem = (ens.n_chips, x_bits.shape[-2], ens.n_out, ens.rows)
            route = use_kernel
            if route is None:
                route = (cfg.accumulation == "single_shot"
                         and (device is None or device.analytic_periphery)
                         and autotune.kernel_wins(*problem, backend=backend))
            if route:
                out = ensemble_apply_kernel(
                    ens, x_bits, cfg=cfg_ni, spec=self.spec,
                    sa_extra_units=sa_extra, output=output,
                    per_chip_x=per_chip, impl=kernel_impl,
                    tile=autotune.best_blocks(*problem, backend=backend),
                    device=device)
            else:
                out = ensemble_apply(ens, x_bits, cfg=cfg_ni, spec=self.spec,
                                     accumulation=cfg.accumulation,
                                     partial_rows=cfg.partial_rows,
                                     sa_extra_units=sa_extra, output=output,
                                     per_chip_x=per_chip, device=device)
            del x_bits
            outs.append(out.reshape(out.shape[0], B, H, W, cfg.group))
        del xg
        return torch.cat(outs, dim=-1)

    def _gconv_train_ensemble(self, blk, groups, x: torch.Tensor, cin: int,
                              cout: int, *, key: torch.Tensor,
                              cfg_ni: ni.NonidealConfig,
                              use_kernel: Optional[bool] = None,
                              kernel_impl: str = "kernel", device=None
                              ) -> torch.Tensor:
        """mode="train_ensemble" group conv (paper Sec. V at population
        scale): the differentiable pre-activation, chips folded into the
        batch so one conv serves every chip, plus for each chip of the
        deviation population `groups`:
          * its frozen linear device-variation error, the ensemble group
            conv on the (effective - nominal) conductance deltas with every
            effect off (`output="diff"`, routed by `use_kernel` as in
            `_gconv_ensemble`), without gradient;
          * a fresh SA-offset draw (std 0.5 g(p_pair)) keyed
            fold_in(key, chip_id), so a chip's slice does not depend on the
            ensemble it is evaluated in.
        x is [B,H,W,cin] (chip-shared) or [chips,B,H,W,cin]; returns
        [chips,B,H,W,cout] binary activations."""
        n_chips = groups[0].n_chips
        xf = x.reshape((-1,) + x.shape[-3:])
        pre, wq = self._gconv_pre(blk, xf, cin, cout)
        pre = pre.reshape(x.shape[:-1] + (cout,))
        if cfg_ni.device_variation:
            with torch.no_grad():
                dev = self._gconv_ensemble(
                    groups, x.detach(), cin, cout,
                    cfg_ni=ni.NonidealConfig.none(), output="diff",
                    use_kernel=use_kernel, kernel_impl=kernel_impl,
                    device=device)
            pre = pre + dev                    # adds the chips axis
        if pre.ndim == 4:
            pre = pre.expand((n_chips,) + pre.shape)
        if cfg_ni.sa_variation:
            std = 0.5 * ni.sa_required_diff(self._p_pair(x, wq, cin),
                                            self.spec)
            eps = prng.normal(prng.fold_in(key, groups[0].chip_ids),
                              pre.shape[1:])
            pre = add_noise(pre, std, eps)
        return binary_activation(pre)

    # ------------------------------------------------------------ BN calib
    def calibrate_bn(self, params: Params, images: torch.Tensor) -> Params:
        """BN running stats (population mean/var) from a calibration batch.
        Both designs: the digital stem's, with which eval and ensemble modes
        normalize.  The baseline also: each block's in-memory BN stats, from
        its ideal grouped conv on the propagated {0,1} activations (normalized
        with |gamma|, the fold `group_mappings` uses), which the mapping
        folds into bias cells."""
        cfg = self.cfg
        params = dict(params)
        x = _stem_conv(images, params["stem"])
        bn = dict(params["stem_bn"])
        bn["mean"] = torch.mean(x, dim=(0, 1, 2))
        bn["var"] = torch.var(x, dim=(0, 1, 2), unbiased=False)
        params["stem_bn"] = bn
        if not cfg.use_bn:
            return params
        x = binary_activation(bn["gamma"] * (x - bn["mean"])
                              / xo.sqrt(bn["var"] + 1e-5) + bn["beta"])
        last_stage = 0
        for name, _, s, cin, ch in self.blocks():
            if s != last_stage:
                x = _max_pool_same(x)
                last_stage = s
            if cin < ch:
                x = torch.cat([x] * (ch // cin), dim=-1)
                cin = ch
            blk = dict(params[name])
            pre = _grouped_conv(x, self._gconv_weights(blk, cin, ch))
            bnp = dict(blk["bn"])
            bnp["mean"] = torch.mean(pre, dim=(0, 1, 2))
            bnp["var"] = torch.var(pre, dim=(0, 1, 2), unbiased=False)
            blk["bn"] = bnp
            params[name] = blk
            x = binary_activation(bnp["gamma"].abs() * (pre - bnp["mean"])
                                  / xo.sqrt(bnp["var"] + 1e-5)
                                  + bnp["beta"])
        return params

    # ------------------------------------------------------------ forward
    def apply(self, params: Params, images: torch.Tensor, *,
              mode: str = "eval", key: Optional[torch.Tensor] = None,
              cfg_ni: ni.NonidealConfig = ni.NonidealConfig.none(),
              sa_extra: float = 0.0, ensemble=None,
              use_kernel: Optional[bool] = None,
              kernel_impl: str = "kernel", device=None) -> torch.Tensor:
        """images [B,H,W,3] in [0,1] -> head predictions.

        mode="train": differentiable QAT -> [B,gh,gw,A*(5+C)], one noise
        draw per block keyed fold_in(key, s*10+b); mode="train_ensemble":
        ensemble-aware QAT over `ensemble`, a deviation population from
        `build_train_ensemble` -> [chips,B,gh,gw,A*(5+C)]; mode="eval": one
        chip (identity `key`) -> [B,gh,gw,A*(5+C)]; mode="ensemble": every
        chip of `ensemble` (a `DetectorEnsemble`) ->
        [chips,B,gh,gw,A*(5+C)], chip c matching mode="eval" with key
        fold_in(base_key, c) up to float32 near-ties.  `key` defaults to
        PRNGKey(0) on the images' device.  The train modes normalize the
        stem with batch statistics, the others with `calibrate_bn`'s.
        The ensemble modes route each group conv by `use_kernel` (None:
        the autotuner's table; True: the fused IRC MVM; False: the plain
        batched route; see `_gconv_ensemble`).  `device` is the device
        model (None: analytic)."""
        if mode not in ("train", "train_ensemble", "eval", "ensemble"):
            raise ValueError(f"unknown mode {mode!r}")
        if key is None:
            key = prng.PRNGKey(0, device=images.device)
        x = _stem_conv(images, params["stem"])
        bn = params["stem_bn"]
        if mode in ("train", "train_ensemble"):
            x = _batch_norm(x, bn["gamma"], bn["beta"])
        else:
            x = bn["gamma"] * (x - bn["mean"]) / xo.sqrt(bn["var"] + 1e-5) \
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
                    sa_extra=sa_extra, use_kernel=use_kernel,
                    kernel_impl=kernel_impl, device=device)
            elif mode == "train_ensemble":
                x = self._gconv_train_ensemble(
                    params[name], ensemble.layers[name], x, cin, ch,
                    key=prng.fold_in(key, layer_id), cfg_ni=cfg_ni,
                    use_kernel=use_kernel, kernel_impl=kernel_impl,
                    device=device)
            elif mode == "train":
                x = self._gconv_train(params[name], x, cin, ch,
                                      key=prng.fold_in(key, layer_id),
                                      cfg_ni=cfg_ni)
            else:
                x = self._gconv_structural(
                    params[name], x, cin, ch,
                    key=prng.fold_in(key, layer_id), cfg_ni=cfg_ni,
                    sa_extra=sa_extra, device=device)
        x = _max_pool_same(x)
        return x @ params["head"] + params["head_b"]
