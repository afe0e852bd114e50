"""Whole-network chip-ensemble MC for the IRC detector (Table II, in the
paper's own units: per-chip mAP@0.5 over a population of sampled dies).

Chip `c`, layer `l = s*10+b`, group `g` is sampled with
`fold_in(fold_in(fold_in(key, c), l), g)`, the reference's key lattice, so
chip `c` here is chip `c` of the JAX package and of `apply(mode="eval",
key=fold_in(key, c))`.  Each chunk of chips runs one ensemble forward on the
device (every group conv one launch of the fused IRC MVM kernel, or the
plain batched route where the autotuner's table says it is faster on this
card: `use_kernel`), then its predictions come back to the host, where each chip's mAP folds into
streaming Welford/quantile accumulators.

`build_train_ensemble` draws the same dies as deviation planes for
ensemble-aware QAT; `committee_wave_forward` answers one wave of serving
requests (`repro_torch.serve`), each from its own committee of dies.

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
from repro_torch.mc.ensemble import (ChipEnsemble, deviation_planes,
                                     sample_ensemble_with_keys)
from repro_torch.mc.stats import StreamingMoments
from repro_torch.obs import (ConvergenceMonitor, PhaseTimer, RunLog, as_runlog,
                             spans)


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


def build_train_ensemble(key: torch.Tensor, det, params, n_chips: int = 0,
                         *, chip_ids: Optional[torch.Tensor] = None,
                         cfg: ni.NonidealConfig = ni.NonidealConfig.all(),
                         device=None) -> DetectorEnsemble:
    """Train-time chip population: every layer's `deviation_planes`, from
    the same dies as `build_detector_ensemble` (chip c here is chip c
    there), so `mode="train_ensemble"` can add each chip's frozen variation
    error to the QAT pre-activation.  The QAT step rebuilds it from the
    current weights every step; the dies change only with `key`."""
    ens = build_detector_ensemble(key, det, params, n_chips,
                                  chip_ids=chip_ids, cfg=cfg, device=device)
    return DetectorEnsemble(
        layers={name: tuple(deviation_planes(g, det.spec, device)
                            for g in groups)
                for name, groups in ens.layers.items()},
        chip_ids=ens.chip_ids)


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
                        sa_extra: float, meta,
                        use_kernel: Optional[bool] = None,
                        kernel_impl: str = "kernel",
                        device=None) -> torch.Tensor:
    """Sample one chunk's `DetectorEnsemble` from the hoisted planes and run
    the ensemble forward, each group conv routed by `use_kernel`
    (`IRCDetector.apply`): [chips, B, gh, gw, A*(5+C)]."""
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
                     cfg_ni=cfg_ni, sa_extra=sa_extra, use_kernel=use_kernel,
                     kernel_impl=kernel_impl, device=device)


def committee_wave_forward(params, images, request_keys, chip_ids, planes,
                           *, det_cfg, spec: MacroSpec,
                           cfg_ni: ni.NonidealConfig, sa_extra: float, meta,
                           use_kernel: Optional[bool] = None,
                           kernel_impl: str = "kernel",
                           device=None) -> torch.Tensor:
    """One serving wave: every request lane gets its own chip committee.

    `images` is [lanes, H, W, 3] and `request_keys` [lanes, 2], one
    fold_in(root, request_id) per lane.  Each lane is its own
    `_sample_and_forward` at batch 1, keyed only by its request key: the
    per-read SA noise shapes would otherwise couple lanes through the batch
    axis, and a request's draws would depend on its wave.  So lane i is
    bit-identical to `run_mc_detector(request_keys[i], ...)` at the same
    chip ids.  The serving engine passes live lanes only (no pad lanes:
    nothing here is compiled for a fixed shape).  Returns
    [lanes, chips, gh, gw, ho]."""
    return torch.stack([
        _sample_and_forward(params, images[i:i + 1], request_keys[i],
                            chip_ids, planes, det_cfg=det_cfg, spec=spec,
                            cfg_ni=cfg_ni, sa_extra=sa_extra, meta=meta,
                            use_kernel=use_kernel, kernel_impl=kernel_impl,
                            device=device)[:, 0]
        for i in range(images.shape[0])])


class _ToHost:
    """Predictions on their way to the host: a pinned buffer filled by a
    non-blocking copy, and an event recorded after it on the stream that
    computed them (a thread's current stream, so the serving engine's
    scheduler thread waits on its own work).  Given `start`, a timing event
    recorded before the work's first launch (`spans.device_mark`), the
    copy's event times too, and `device_ms` reads the device's time from
    one to the other once `wait` returned."""

    def __init__(self, preds: torch.Tensor, start=None):
        self.start = start
        if preds.is_cuda:
            self.buf = torch.empty(preds.shape, dtype=preds.dtype,
                                   pin_memory=True)
            self.buf.copy_(preds, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=start is not None)
            self.event.record(torch.cuda.current_stream(preds.device))
        else:
            self.buf, self.event = preds, None

    def wait(self) -> np.ndarray:
        """Block until the copy landed; the predictions as numpy."""
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()

    def device_ms(self) -> Optional[float]:
        """Device milliseconds from `start` to the copy's landing (after
        `wait`); None without a start or off the card."""
        return spans.elapsed_ms(self.start, self.event)


def run_mc_detector(key: torch.Tensor, det, params, images: torch.Tensor,
                    gt_boxes: List[np.ndarray],
                    gt_classes: List[np.ndarray], *,
                    mc: McConfig = McConfig(), sa_extra: float = 0.0,
                    obs: Optional[RunLog] = None,
                    stderr_target: Optional[float] = None,
                    pipeline: bool = True,
                    use_kernel: Optional[bool] = None,
                    kernel_impl: str = "kernel") -> McResult:
    """Stream a chip population of the whole detector over an eval batch.

    Runs on the device that `key`, `params` and `images` live on.  The
    metric is "map50"; chip c is keyed fold_in(key, c) whatever the
    chunking.  `pipeline=True` hoists the group mappings and overlaps chunk
    k+1 on the device with chunk k's host-side mAP; per-chip results are
    identical to `pipeline=False` (eager ensemble build, blocking forward).
    `params` should carry calibrated stem-BN stats (`det.calibrate_bn`).

    `obs` receives the reference's events (phase "mc_detector");
    `stderr_target` stops at the first chunk boundary where the mAP's
    standard error reaches it.  The pipelined sweep then drops the one
    chunk it has in flight, so both paths stop at the same boundary with
    the same moments, those of the full run's prefix.

    `use_kernel` routes each group conv (`IRCDetector.apply`): None (the
    default) as the autotuner's table says for this card, True through the
    fused IRC MVM, False through the plain batched route; `kernel_impl`
    ("kernel" | "ref") is the kernel route's implementation.

    While a profiler trace runs the sweep is an `mc_detector_call` span
    (`chips`, `chunk_size`) holding per chunk an `mc_detector_chunks` span
    (`chunk`, `chip_lo`, `chips`) with its `mc_detector_enqueue`,
    `mc_detector_copy_wait` and `mc_detector_host` spans; host scoring
    opens `score_map` inside (`evaluate_map_per_chip`, with the boxes
    counters).  On the card a chunk span carries `device_ms`: timing
    events from just before the chunk's first launch to its copy's
    landing, read after the wait the sweep already makes.  Pipelined, the
    start event runs once the previous chunk's work is done, so the span
    covers the device from there to this chunk's copy, bubbles in it
    included."""
    from repro_torch.train.det_loss import evaluate_map_per_chip

    with spans.span("mc_detector_call", chips=mc.n_chips,
                    chunk_size=mc.chunk_size):
        obs = as_runlog(obs)
        moments = {"map50": StreamingMoments(mc.quantiles)}
        monitor = ConvergenceMonitor(moments, stderr_target=stderr_target,
                                     runlog=obs, phase="mc_detector")
        timer = PhaseTimer("mc_detector_chunks", unit="chips")
        enq_timer = PhaseTimer("mc_detector_enqueue", unit="chips")
        dev_timer = PhaseTimer("mc_detector_copy_wait", unit="chips")
        host_timer = PhaseTimer("mc_detector_host", unit="chips")
        obs.log_event("mc_start", phase="mc_detector", n_chips=mc.n_chips,
                      chunk_size=mc.chunk_size, stderr_target=stderr_target,
                      pipeline=pipeline,
                      device_model=(mc.device.name if mc.device is not None
                                    else "analytic"))
        chunks = [_chip_range(lo, min(lo + mc.chunk_size, mc.n_chips), key)
                  for lo in range(0, mc.n_chips, mc.chunk_size)]

        def score(preds: np.ndarray) -> np.ndarray:
            return evaluate_map_per_chip(preds, gt_boxes, gt_classes,
                                         det.cfg.n_anchors, det.cfg.n_classes)

        hoisted = None

        def dispatch(chunk_i: int) -> _ToHost:
            """Enqueue one chunk's sample + forward + copy to the host (the
            first call also hoists the group mappings)."""
            nonlocal hoisted
            ids = chunks[chunk_i]
            with enq_timer.lap(items=int(ids.shape[0]), chunk=chunk_i,
                               chip_lo=chunk_i * mc.chunk_size):
                start = spans.device_mark(images.device)
                if hoisted is None:
                    hoisted = detector_planes(det, params)
                planes, meta = hoisted
                return _ToHost(_sample_and_forward(
                    params, images, key, ids, planes, det_cfg=det.cfg,
                    spec=det.spec, cfg_ni=mc.cfg, sa_extra=sa_extra, meta=meta,
                    use_kernel=use_kernel, kernel_impl=kernel_impl,
                    device=mc.device), start)

        n_done = 0
        for chunk_i, ids in enumerate(chunks):
            n_chunk = int(ids.shape[0])
            at = {"chunk": chunk_i, "chip_lo": chunk_i * mc.chunk_size}
            with timer.lap(items=n_chunk, chips=n_chunk, **at) as lap:
                if pipeline:
                    if chunk_i == 0:
                        inflight = dispatch(0)
                    with dev_timer.lap(items=n_chunk, **at):
                        preds = inflight.wait()
                    device_ms = inflight.device_ms()
                    if chunk_i + 1 < len(chunks):
                        inflight = dispatch(chunk_i + 1)
                else:
                    with enq_timer.lap(items=n_chunk, **at):
                        start = spans.device_mark(images.device)
                        ens = build_detector_ensemble(key, det, params,
                                                      chip_ids=ids, cfg=mc.cfg,
                                                      device=mc.device)
                        out = det.apply(params, images, mode="ensemble",
                                        ensemble=ens, cfg_ni=mc.cfg,
                                        sa_extra=sa_extra,
                                        use_kernel=use_kernel,
                                        kernel_impl=kernel_impl,
                                        device=mc.device)
                        end = spans.device_mark(images.device)
                    with dev_timer.lap(items=n_chunk, **at):
                        preds = out.cpu().numpy()
                    device_ms = spans.elapsed_ms(start, end)
                if device_ms is not None:
                    lap.span.set(device_ms=device_ms)
                with host_timer.lap(items=n_chunk, **at):
                    vals = score(preds)
            n_done += n_chunk
            moments["map50"].update(vals)
            obs.log_event("chunk", phase="mc_detector", chunk=chunk_i,
                          chip_lo=n_done - n_chunk, chips=n_done,
                          wall_s=timer.last_s,
                          device_s=dev_timer.last_s, host_s=host_timer.last_s,
                          values={"map50":
                                  np.asarray(vals, np.float32).ravel()})
            if monitor.after_chunk(chunk_i, n_done):
                obs.log_event("early_stop", chips=n_done, requested=mc.n_chips,
                              stderr_target=stderr_target)
                break

        res = McResult(
            n_chips=n_done,
            metrics={name: m.summary() for name, m in moments.items()},
            per_chip={name: m.per_chip for name, m in moments.items()},
            wall_s=timer.total_s, chips_per_sec=timer.rate(),
            compile_s=timer.compile_s, enqueue_s=enq_timer.total_s,
            device_s=dev_timer.total_s, host_s=host_timer.total_s)
        obs.log_event("mc_result", phase="mc_detector", chips=n_done,
                      requested=mc.n_chips, wall_s=res.wall_s,
                      compile_s=res.compile_s, chips_per_sec=res.chips_per_sec,
                      device_s=res.device_s, host_s=res.host_s,
                      pipeline=pipeline, enqueue_s=res.enqueue_s,
                      metrics=res.metrics)
        return res


def run_ablation_detector(key: torch.Tensor, det, params, images,
                          gt_boxes: List[np.ndarray],
                          gt_classes: List[np.ndarray], *,
                          ablations: Sequence[Tuple[str, ni.NonidealConfig]]
                          = TABLE2_ABLATION,
                          mc: McConfig = McConfig(),
                          obs: Optional[RunLog] = None,
                          stderr_target: Optional[float] = None,
                          pipeline: bool = True,
                          use_kernel: Optional[bool] = None,
                          kernel_impl: str = "kernel"
                          ) -> Dict[str, McResult]:
    """Table II for the detector: one population mAP sweep per effect
    column, on the same chip key stream, each routed by `use_kernel` as in
    `run_mc_detector`; each column opens with an `ablation_column` event."""
    obs = as_runlog(obs)
    results = {}
    for name, cfg in ablations:
        obs.log_event("ablation_column", phase="mc_detector", column=name)
        results[name] = run_mc_detector(
            key, det, params, images, gt_boxes, gt_classes,
            mc=dataclasses.replace(mc, cfg=cfg), obs=obs,
            stderr_target=stderr_target, pipeline=pipeline,
            use_kernel=use_kernel, kernel_impl=kernel_impl)
    return results
