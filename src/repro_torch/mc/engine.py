"""Chip-ensemble engine: one batched computation evaluates a whole chip
population.

Two routes give every chip of a `ChipEnsemble` on a batch of word lines:
`ensemble_apply`, the plain batched route (both accumulation modes, any
device model), and `ensemble_apply_kernel`, one launch of the fused IRC MVM
(single-shot, analytic periphery).  Both draw each chip's per-read
periphery noise from its SA key with the reference's key discipline
(`split(k_sa)` -> normal offsets and bernoulli(0.5) fallback bits of shape
(B, N)).  `run_mc` streams a layer's population through them in chunks,
folding per-chip metrics into Welford/quantile accumulators, and
`run_ablation` sweeps the Table II effect columns.  Chunking is invisible:
chip c is keyed by `fold_in(key, c)` whichever chunk evaluates it.
`McConfig`/`McResult`/`TABLE2_ABLATION` also carry the whole-detector
sweeps of `repro_torch.mc.detector_mc`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.crossbar import _accumulate, _block_reduce
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import MappedLayer, extend_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import IrcEpilogueParams, irc_mvm_chips_ref
from repro_torch.mc.ensemble import (ChipEnsemble, calibrate_ensemble_bias,
                                     sample_ensemble)
from repro_torch.mc.stats import DEFAULT_QUANTILES, StreamingMoments
from repro_torch.obs import (ConvergenceMonitor, PhaseTimer, RunLog, as_runlog,
                             spans)


def periphery_noise(sa_keys: torch.Tensor, B: int, N: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chip SA offsets ~N(0,1) and fallback bits {0,1}, each [C, B, N],
    from the chips' SA keys [C, 2] (split once: offsets, then bits)."""
    ks = prng.split(sa_keys)
    eps_sa = prng.normal(ks[..., 0, :], (B, N))
    rnd = prng.bernoulli(ks[..., 1, :], 0.5, (B, N))
    return eps_sa, rnd


def ensemble_apply(ens: ChipEnsemble, x_bits: torch.Tensor, *,
                   cfg: ni.NonidealConfig, spec: MacroSpec = DEFAULT_MACRO,
                   accumulation: str = "single_shot", partial_rows: int = 256,
                   sa_extra_units: float = 0.0, output: str = "binary",
                   per_chip_x: bool = False, device=None) -> torch.Tensor:
    """Every chip of `ens` on x_bits -> [chips, B, n_out], the plain batched
    route: chip c equals `crossbar_forward(fold_in(key, c), ...)` up to
    float32 summation order.

    x_bits is [B, fan_in] shared by every chip, or [chips, B, fan_in] with
    `per_chip_x`.  The activated-LRS counts are sums of {0,1} products,
    exact in float32 in any order: with shared placement planes and shared
    word lines they are chip-independent and computed once ([B, nb, N]);
    per-chip planes (calibrated dies) or per-chip word lines give them a
    chips axis.  output="binary" gives SA decisions, "diff" the analog
    difference, "sensed_diff" the difference each chip's periphery reports
    (`ni.sensed_diff`, the same split of each chip's SA key)."""
    if output not in ("binary", "diff", "sensed_diff"):
        raise ValueError(f"output must be 'binary', 'diff' or "
                         f"'sensed_diff', got {output!r}")
    if per_chip_x:
        assert x_bits.ndim == 3 and x_bits.shape[0] == ens.n_chips, (
            f"per_chip_x needs [chips={ens.n_chips}, batch, fan_in] inputs, "
            f"got {tuple(x_bits.shape)}")
    x_ext = extend_rows(x_bits, ens.lead_rows)
    blk = spec.ir_block
    i_pos, p_pos = _accumulate(_block_reduce(x_ext, ens.ep, blk),
                               _block_reduce(x_ext, ens.gp, blk), cfg, spec,
                               accumulation, partial_rows, device)
    i_neg, p_neg = _accumulate(_block_reduce(x_ext, ens.en, blk),
                               _block_reduce(x_ext, ens.gn, blk), cfg, spec,
                               accumulation, partial_rows, device)
    if output == "diff":
        return i_pos - i_neg
    sense = ni.sensed_diff if output == "sensed_diff" else ni.resolve_sa
    return sense(ens.sa_keys, i_pos, i_neg, p_pos + p_neg, cfg, spec,
                 sa_extra_units, device)


def ensemble_apply_kernel(ens: ChipEnsemble, x_bits: torch.Tensor, *,
                          cfg: ni.NonidealConfig,
                          spec: MacroSpec = DEFAULT_MACRO,
                          sa_extra_units: float = 0.0, output: str = "binary",
                          per_chip_x: bool = False, impl: str = "kernel",
                          tile: Optional[Tuple[int, int]] = None,
                          device=None) -> torch.Tensor:
    """Every chip of `ens` on x_bits -> [chips, B, n_out] in one launch.

    x_bits is [B, fan_in] shared by every chip, or [chips, B, fan_in] with
    `per_chip_x` (chip-diverged activations downstream of the first IRC
    layer).  `impl="kernel"` goes through `ops.irc_mvm_chips` at row tile
    `tile` (None: the default; `repro_torch.kernels.autotune.best_blocks`
    gives the tuned one), the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors; `impl="ref"` calls the plain version on any
    device, the route against which the kernel is held.  Single-shot
    accumulation and the analytic periphery only: the kernel's epilogue
    bakes both in."""
    if device is not None and not device.analytic_periphery:
        raise NotImplementedError(
            f"device model {device.name!r} has a non-analytic periphery; "
            "the chip-batched kernel supports analytic-periphery backends "
            "only — use the plain route (backend='plain')")
    if per_chip_x:
        assert x_bits.ndim == 3 and x_bits.shape[0] == ens.n_chips, (
            f"per_chip_x needs [chips={ens.n_chips}, batch, fan_in] inputs, "
            f"got {tuple(x_bits.shape)}")
    x_ext = extend_rows(x_bits, ens.lead_rows)
    B, N = x_ext.shape[-2], ens.n_out
    eps_sa, rnd = periphery_noise(ens.sa_keys, B, N)
    params = IrcEpilogueParams.from_macro(
        spec, sa_extra=sa_extra_units, output=output,
        apply_nonlinearity=cfg.nonlinearity, apply_ir=cfg.ir_drop,
        apply_sa=cfg.sa_variation, apply_range=cfg.sensing_range)
    if impl == "ref":
        return irc_mvm_chips_ref(x_ext, ens.ep, ens.en, ens.gp, ens.gn,
                                 eps_sa, rnd, params)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return ops.irc_mvm_chips(x_ext, ens.ep, ens.en, ens.gp, ens.gn, eps_sa,
                             rnd, params, tile=tile)


@dataclasses.dataclass(frozen=True)
class McConfig:
    """One ensemble sweep: population size, chunking, effect toggles, the
    accumulation mode, the layer sweep's backend ("plain": `ensemble_apply`;
    "kernel": the fused IRC MVM, single-shot only) and per-die bias
    calibration, the reported quantiles and the device model (None:
    analytic)."""
    n_chips: int = 64
    chunk_size: int = 32
    cfg: ni.NonidealConfig = ni.NonidealConfig.all()
    accumulation: str = "single_shot"
    partial_rows: int = 256
    sa_extra_units: float = 0.0
    backend: str = "plain"               # "plain" | "kernel"
    calibrate: bool = False
    quantiles: Tuple[float, ...] = DEFAULT_QUANTILES
    device: Optional[object] = None      # repro_torch.device.DeviceModel


@dataclasses.dataclass
class McResult:
    """Ensemble statistics for one sweep.

    `wall_s` covers the whole sweep; `compile_s` is the first chunk's wall
    (on the card it holds the kernel build and first-launch costs);
    `chips_per_sec` is the steady rate over the later chunks.
    `enqueue_s` is the host time spent sampling chips and enqueueing their
    forward (on the CPU the work itself runs there), `device_s` the host's
    wait on the copy of the chunks' results (the reference's name: it is
    not the device's time, which a chunk span's `device_ms` gives while a
    profiler trace runs, `repro_torch.obs.spans`), and `host_s` the
    host-side scoring time.  `bias_units` holds each chip's calibrated bias
    rows when the sweep calibrated its dies."""
    n_chips: int
    metrics: Dict[str, Dict[str, float]]
    per_chip: Dict[str, np.ndarray]
    wall_s: float
    chips_per_sec: float
    compile_s: float = 0.0
    enqueue_s: float = 0.0
    device_s: float = 0.0
    host_s: float = 0.0
    bias_units: Optional[np.ndarray] = None

    def summary_line(self, metric: str = "map50") -> str:
        """One-line mean±std + quantile report for `metric`."""
        m = self.metrics[metric]
        qs = ";".join(f"{k}={v:.4f}" for k, v in sorted(m.items())
                      if k.startswith("q"))
        return (f"{metric}={m['mean']:.4f}±{m['std']:.4f} "
                f"({qs}) over {self.n_chips} chips "
                f"[{self.chips_per_sec:.1f} chips/s steady, "
                f"first chunk {self.compile_s:.2f}s]")


MetricFn = Callable[[torch.Tensor], torch.Tensor]  # [chips,B,N] -> [chips]
HostMetricFn = Callable[[np.ndarray], np.ndarray]  # [chips,B,N] -> [chips]


def bit_agreement_metric(ref_bits: torch.Tensor) -> MetricFn:
    """Per-chip fraction of SA decisions that agree with the ideal digital
    output `ref_bits` [B, N] (the mAP-drop proxy of the layer sweep)."""
    ref = (ref_bits > 0.5).float()
    return lambda out: torch.mean(((out > 0.5).float() == ref).float(),
                                  dim=(-2, -1))


def ones_fraction_metric() -> MetricFn:
    """Per-chip fraction of 1-bits in the output (a drift indicator)."""
    return lambda out: torch.mean(out, dim=(-2, -1))


def run_mc(key: torch.Tensor, mapped: MappedLayer, x_bits: torch.Tensor, *,
           ref_bits: Optional[torch.Tensor] = None, mc: McConfig = McConfig(),
           spec: MacroSpec = DEFAULT_MACRO,
           metric_fns: Optional[Dict[str, MetricFn]] = None,
           host_metric_fns: Optional[Dict[str, HostMetricFn]] = None,
           obs: Optional[RunLog] = None,
           stderr_target: Optional[float] = None,
           stderr_metric: Optional[str] = None) -> McResult:
    """Stream a population of `mc.n_chips` sampled chips of one mapped
    layer over x_bits [B, fan_in], `mc.chunk_size` chips at a time.

    Runs on the device that `key`, the planes and x_bits live on.
    `ref_bits` ([B, n_out] ideal binary output) adds the `bit_agreement`
    metric beside `ones_fraction`; `metric_fns` add reductions on the
    device, `host_metric_fns` callbacks on the chunk's outputs in numpy.
    With `mc.calibrate` each chunk's dies are bias-calibrated on x_bits
    before the forward.

    `obs` (a `repro_torch.obs.RunLog`) receives the reference's event
    stream: `mc_start`, a `chunk` per chunk with its raw per-chip values
    (replayable to the reported moments bit for bit), a `convergence`
    after it, and `mc_result`.  While a profiler trace runs the sweep is
    an `mc_call` span (`chips`, `chunk_size`) holding per chunk an
    `mc_chunks` span (`chunk`, `chip_lo`, `chips`, and on the card
    `device_ms`: timing events from before the chunk's first launch to
    after its last, read once the host's copy returned) and its
    `mc_enqueue`, `mc_copy_wait` and `mc_host` spans.  `stderr_target` stops the sweep at the
    first chunk boundary where the standard error of the mean of every
    metric (or of `stderr_metric` alone) is at or under the target; chip c
    is keyed fold_in(key, c) whatever the chunking, so the stopped sweep's
    moments are those of the same-length prefix of the full run."""
    obs = as_runlog(obs)
    if mc.backend not in ("plain", "kernel"):
        raise ValueError(f"backend must be 'plain' or 'kernel', got "
                         f"{mc.backend!r}")
    if mc.backend == "kernel" and mc.accumulation != "single_shot":
        raise ValueError("kernel backend fuses the single-shot path only")
    with spans.span("mc_call", chips=mc.n_chips, chunk_size=mc.chunk_size):
        fns: Dict[str, MetricFn] = {}
        if ref_bits is not None:
            fns["bit_agreement"] = bit_agreement_metric(ref_bits)
        fns["ones_fraction"] = ones_fraction_metric()
        fns.update(metric_fns or {})
        host_fns: Dict[str, HostMetricFn] = dict(host_metric_fns or {})
        moments = {name: StreamingMoments(mc.quantiles)
                   for name in (*fns, *host_fns)}
        monitor = ConvergenceMonitor(moments, stderr_target=stderr_target,
                                     stderr_metric=stderr_metric, runlog=obs)
        timer = PhaseTimer("mc_chunks", unit="chips")
        enq_timer = PhaseTimer("mc_enqueue", unit="chips")
        dev_timer = PhaseTimer("mc_copy_wait", unit="chips")
        host_timer = PhaseTimer("mc_host", unit="chips")
        # the reference's fields; "fused" names its cached one-program chunk,
        # which the port has no counterpart of
        obs.log_event("mc_start", n_chips=mc.n_chips, chunk_size=mc.chunk_size,
                      backend=mc.backend, calibrate=mc.calibrate, fused=False,
                      stderr_target=stderr_target,
                      device_model=(mc.device.name if mc.device is not None
                                    else "analytic"))
        bias_chunks: List[np.ndarray] = []
        n_done = 0
        for chunk_i, lo in enumerate(range(0, mc.n_chips, mc.chunk_size)):
            ids = torch.arange(lo, min(lo + mc.chunk_size, mc.n_chips),
                               dtype=torch.int64, device=key.device)
            n_chunk = int(ids.shape[0])
            at = {"chunk": chunk_i, "chip_lo": lo}
            with timer.lap(items=n_chunk, chips=n_chunk, **at) as lap:
                with enq_timer.lap(items=n_chunk, **at):
                    start = spans.device_mark(key.device)
                    ens = sample_ensemble(key, mapped, chip_ids=ids,
                                          cfg=mc.cfg, spec=spec,
                                          device=mc.device)
                    if mc.calibrate:
                        ens = calibrate_ensemble_bias(ens, x_bits, spec,
                                                      device=mc.device)
                        bias_chunks.append(ens.bias_units.cpu().numpy())
                    if mc.backend == "kernel":
                        out = ensemble_apply_kernel(
                            ens, x_bits, cfg=mc.cfg, spec=spec,
                            sa_extra_units=mc.sa_extra_units, device=mc.device)
                    else:
                        out = ensemble_apply(
                            ens, x_bits, cfg=mc.cfg, spec=spec,
                            accumulation=mc.accumulation,
                            partial_rows=mc.partial_rows,
                            sa_extra_units=mc.sa_extra_units, device=mc.device)
                    del ens
                    on_device = {name: fn(out) for name, fn in fns.items()}
                    end = spans.device_mark(key.device)
                with dev_timer.lap(items=n_chunk, **at):
                    vals = {name: v.cpu().numpy()
                            for name, v in on_device.items()}
                    out_np = out.cpu().numpy() if host_fns else None
                del out, on_device
                if start is not None:
                    lap.span.set(device_ms=spans.elapsed_ms(start, end))
                with host_timer.lap(items=n_chunk, **at):
                    for name, fn in host_fns.items():
                        vals[name] = np.asarray(fn(out_np))
                    for name, v in vals.items():
                        moments[name].update(v)
            n_done += n_chunk
            obs.log_event("chunk", phase="mc", chunk=chunk_i, chip_lo=lo,
                          chips=n_done, wall_s=timer.last_s,
                          values={name: np.asarray(v, np.float32).ravel()
                                  for name, v in vals.items()})
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
            device_s=dev_timer.total_s, host_s=host_timer.total_s,
            bias_units=np.concatenate(bias_chunks) if bias_chunks else None)
        obs.log_event("mc_result", chips=n_done, requested=mc.n_chips,
                      wall_s=res.wall_s, compile_s=res.compile_s,
                      chips_per_sec=res.chips_per_sec, enqueue_s=res.enqueue_s,
                      metrics=res.metrics)
        return res


# Table II columns: effects switch on cumulatively, plus the all-on row.
TABLE2_ABLATION: Tuple[Tuple[str, ni.NonidealConfig], ...] = (
    ("ideal", ni.NonidealConfig.none()),
    ("devvar", ni.NonidealConfig(device_variation=True)),
    ("devvar+nl", ni.NonidealConfig(device_variation=True, nonlinearity=True)),
    ("devvar+nl+peri", ni.NonidealConfig(device_variation=True,
                                         nonlinearity=True, sa_variation=True,
                                         sensing_range=True)),
    ("all", ni.NonidealConfig.all()),
)


def run_ablation(key: torch.Tensor, mapped: MappedLayer, x_bits: torch.Tensor,
                 *, ref_bits: torch.Tensor,
                 ablations: Sequence[Tuple[str, ni.NonidealConfig]]
                 = TABLE2_ABLATION,
                 mc: McConfig = McConfig(), spec: MacroSpec = DEFAULT_MACRO,
                 obs: Optional[RunLog] = None,
                 stderr_target: Optional[float] = None,
                 stderr_metric: Optional[str] = None
                 ) -> Dict[str, McResult]:
    """Table II for one layer: one `run_mc` per effect column, on the same
    chip key stream (each column resamples the same dies); each column
    opens with an `ablation_column` event."""
    obs = as_runlog(obs)
    results = {}
    for name, cfg in ablations:
        obs.log_event("ablation_column", phase="mc", column=name)
        results[name] = run_mc(key, mapped, x_bits, ref_bits=ref_bits,
                               mc=dataclasses.replace(mc, cfg=cfg), spec=spec,
                               obs=obs, stderr_target=stderr_target,
                               stderr_metric=stderr_metric)
    return results
