"""Whole-network chip-ensemble MC for the IRC detector (Table II, in the
paper's own units: per-chip mAP@0.5 over a population of sampled dies).

Chip `c`, layer `l = s*10+b`, group `g` is sampled with
`fold_in(fold_in(fold_in(key, c), l), g)`, the reference's key lattice, so
chip `c` here is chip `c` of the JAX package and of `apply(mode="eval",
key=fold_in(key, c))`.  Each chunk of chips runs one ensemble forward on the
device (every group conv one launch of the fused IRC MVM kernel), then its
predictions come back to the host, where each chip's mAP folds into
streaming Welford/quantile accumulators.

The pipelined sweep overlaps the two: chunk k's predictions are copied into
pinned host memory with `non_blocking=True` and an event is recorded, and
only then is chunk k+1 enqueued, so the host waits on chunk k alone and
scores it while the card computes chunk k+1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec
from repro_torch.core.mapping import MappedLayer
from repro_torch.mc.engine import McConfig, McResult, TABLE2_ABLATION
from repro_torch.mc.ensemble import ChipEnsemble, sample_ensemble_with_keys
from repro_torch.mc.stats import StreamingMoments
from repro_torch.obs.timers import PhaseTimer


@dataclasses.dataclass(frozen=True)
class DetectorEnsemble:
    """A chip population of the whole detector: block name -> per-group
    `ChipEnsemble`s (group order of `group_mappings`), and the chip ids
    [chips] shared by every layer."""
    layers: Dict[str, Tuple[ChipEnsemble, ...]]
    chip_ids: torch.Tensor

    @property
    def n_chips(self) -> int:
        """Population size: number of sampled dies."""
        return self.chip_ids.shape[0]


def detector_layer_keys(key: torch.Tensor, chip_ids: torch.Tensor,
                        layer_id: int, g: int) -> torch.Tensor:
    """Per-chip keys [chips, 2] of one (layer, group) crossbar:
    fold_in(fold_in(fold_in(key, c), layer_id), g)."""
    return prng.fold_in(prng.fold_in(prng.fold_in(key, chip_ids), layer_id),
                        g)


def _chip_range(lo: int, hi: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(lo, hi, dtype=torch.int64, device=like.device)


def build_detector_ensemble(key: torch.Tensor, det, params, n_chips: int = 0,
                            *, chip_ids: Optional[torch.Tensor] = None,
                            cfg: ni.NonidealConfig = ni.NonidealConfig.all(),
                            device=None) -> DetectorEnsemble:
    """Sample chips `chip_ids` (default 0..n_chips-1) of every group
    crossbar of the detector; `device` is the device model."""
    if chip_ids is None:
        chip_ids = _chip_range(0, n_chips, key)
    layers = {}
    for name, layer_id, _, cin, ch in det.blocks():
        cin = max(cin, ch)                       # widen-by-repetition
        layers[name] = tuple(
            sample_ensemble_with_keys(
                detector_layer_keys(key, chip_ids, layer_id, g), mapped,
                chip_ids=chip_ids, cfg=cfg, spec=det.spec, device=device)
            for g, mapped in enumerate(det.group_mappings(params[name], cin,
                                                          ch)))
    return DetectorEnsemble(layers=layers, chip_ids=chip_ids)


def detector_planes(det, params):
    """Hoist the per-layer group mappings out of the chunk loop: returns
    (planes, meta), planes a tuple per layer of (g_pos, g_neg) per group and
    meta per layer (name, layer_id, per-group (bias_rows, scheme, fan_in))."""
    planes, meta = [], []
    for name, layer_id, _, cin, ch in det.blocks():
        maps = det.group_mappings(params[name], max(cin, ch), ch)
        planes.append(tuple((m.g_pos, m.g_neg) for m in maps))
        meta.append((name, layer_id,
                     tuple((m.bias_rows, m.scheme, m.fan_in) for m in maps)))
    return tuple(planes), tuple(meta)


def _sample_and_forward(params, images, key, chip_ids, planes, *, det_cfg,
                        spec: MacroSpec, cfg_ni: ni.NonidealConfig,
                        sa_extra: float, meta, kernel_impl: str = "kernel",
                        device=None) -> torch.Tensor:
    """Sample one chunk's `DetectorEnsemble` from the hoisted planes and run
    the ensemble forward: [chips, B, gh, gw, A*(5+C)]."""
    from repro_torch.models.detector import IRCDetector
    det = IRCDetector(det_cfg, spec)
    layers = {}
    for layer_planes, (name, layer_id, gmeta) in zip(planes, meta):
        layers[name] = tuple(
            sample_ensemble_with_keys(
                detector_layer_keys(key, chip_ids, layer_id, g),
                MappedLayer(g_pos=gp, g_neg=gn, bias_rows=bias_rows,
                            scheme=scheme, fan_in=fan_in),
                chip_ids=chip_ids, cfg=cfg_ni, spec=spec, device=device)
            for g, ((gp, gn), (bias_rows, scheme, fan_in)) in enumerate(
                zip(layer_planes, gmeta)))
    ens = DetectorEnsemble(layers=layers, chip_ids=chip_ids)
    return det.apply(params, images, mode="ensemble", ensemble=ens,
                     cfg_ni=cfg_ni, sa_extra=sa_extra,
                     kernel_impl=kernel_impl, device=device)


class _ToHost:
    """One chunk's predictions on their way to the host: a pinned buffer
    filled by a non-blocking copy, and the event that marks it complete."""

    def __init__(self, preds: torch.Tensor):
        if preds.is_cuda:
            self.buf = torch.empty(preds.shape, dtype=preds.dtype,
                                   pin_memory=True)
            self.buf.copy_(preds, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf, self.event = preds, None

    def wait(self) -> np.ndarray:
        """Block until the copy landed; the predictions as numpy."""
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


def run_mc_detector(key: torch.Tensor, det, params, images: torch.Tensor,
                    gt_boxes: List[np.ndarray],
                    gt_classes: List[np.ndarray], *,
                    mc: McConfig = McConfig(), sa_extra: float = 0.0,
                    pipeline: bool = True,
                    kernel_impl: str = "kernel") -> McResult:
    """Stream a chip population of the whole detector over an eval batch.

    Runs on the device that `key`, `params` and `images` live on.  The
    metric is "map50"; chip c is keyed fold_in(key, c) whatever the
    chunking.  `pipeline=True` hoists the group mappings and overlaps chunk
    k+1 on the device with chunk k's host-side mAP; per-chip results are
    identical to `pipeline=False` (eager ensemble build, blocking forward).
    `params` should carry calibrated stem-BN stats (`det.calibrate_bn`)."""
    from repro_torch.train.det_loss import evaluate_map_per_chip

    moments = {"map50": StreamingMoments(mc.quantiles)}
    timer = PhaseTimer("mc_detector_chunks", unit="chips")
    enq_timer = PhaseTimer("mc_detector_enqueue", unit="chips")
    dev_timer = PhaseTimer("mc_detector_device", unit="chips")
    host_timer = PhaseTimer("mc_detector_host", unit="chips")
    chunks = [_chip_range(lo, min(lo + mc.chunk_size, mc.n_chips), key)
              for lo in range(0, mc.n_chips, mc.chunk_size)]

    def score(preds: np.ndarray) -> np.ndarray:
        return evaluate_map_per_chip(preds, gt_boxes, gt_classes,
                                     det.cfg.n_anchors, det.cfg.n_classes)

    hoisted = None

    def dispatch(ids) -> _ToHost:
        """Enqueue one chunk's sample + forward + copy to the host (the
        first call also hoists the group mappings)."""
        nonlocal hoisted
        with enq_timer.lap(items=int(ids.shape[0])):
            if hoisted is None:
                hoisted = detector_planes(det, params)
            planes, meta = hoisted
            return _ToHost(_sample_and_forward(
                params, images, key, ids, planes, det_cfg=det.cfg,
                spec=det.spec, cfg_ni=mc.cfg, sa_extra=sa_extra, meta=meta,
                kernel_impl=kernel_impl, device=mc.device))

    for chunk_i, ids in enumerate(chunks):
        n_chunk = int(ids.shape[0])
        with timer.lap(items=n_chunk):
            if pipeline:
                if chunk_i == 0:
                    inflight = dispatch(ids)
                with dev_timer.lap(items=n_chunk):
                    preds = inflight.wait()
                if chunk_i + 1 < len(chunks):
                    inflight = dispatch(chunks[chunk_i + 1])
            else:
                with enq_timer.lap(items=n_chunk):
                    ens = build_detector_ensemble(key, det, params,
                                                  chip_ids=ids, cfg=mc.cfg,
                                                  device=mc.device)
                    out = det.apply(params, images, mode="ensemble",
                                    ensemble=ens, cfg_ni=mc.cfg,
                                    sa_extra=sa_extra,
                                    kernel_impl=kernel_impl,
                                    device=mc.device)
                with dev_timer.lap(items=n_chunk):
                    preds = out.cpu().numpy()
            with host_timer.lap(items=n_chunk):
                vals = score(preds)
        moments["map50"].update(vals)

    return McResult(
        n_chips=sum(int(i.shape[0]) for i in chunks),
        metrics={name: m.summary() for name, m in moments.items()},
        per_chip={name: m.per_chip for name, m in moments.items()},
        wall_s=timer.total_s, chips_per_sec=timer.rate(),
        compile_s=timer.compile_s, enqueue_s=enq_timer.total_s,
        device_s=dev_timer.total_s, host_s=host_timer.total_s)


def run_ablation_detector(key: torch.Tensor, det, params, images,
                          gt_boxes: List[np.ndarray],
                          gt_classes: List[np.ndarray], *,
                          ablations: Sequence[Tuple[str, ni.NonidealConfig]]
                          = TABLE2_ABLATION,
                          mc: McConfig = McConfig(), pipeline: bool = True,
                          kernel_impl: str = "kernel"
                          ) -> Dict[str, McResult]:
    """Table II for the detector: one population mAP sweep per effect
    column, on the same chip key stream."""
    return {name: run_mc_detector(key, det, params, images, gt_boxes,
                                  gt_classes,
                                  mc=dataclasses.replace(mc, cfg=cfg),
                                  pipeline=pipeline, kernel_impl=kernel_impl)
            for name, cfg in ablations}
