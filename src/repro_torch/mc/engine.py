"""Chip-ensemble engine: one kernel launch evaluates a whole chip population.

`ensemble_apply_kernel` draws each chip's per-read periphery noise from its
SA key (the reference's key discipline: `split(k_sa)` -> normal offsets and
bernoulli(0.5) fallback bits of shape (B, N)) and runs the fused IRC MVM over
the ensemble's leading chips axis.  `McConfig`/`McResult`/`TABLE2_ABLATION`
carry the population sweeps of `repro_torch.mc.detector_mc`.  The plain
batched `ensemble_apply` route, `run_mc` for single layers and per-die
calibration come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import extend_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import IrcEpilogueParams, irc_mvm_chips_ref
from repro_torch.mc.ensemble import ChipEnsemble
from repro_torch.mc.stats import DEFAULT_QUANTILES


def periphery_noise(sa_keys: torch.Tensor, B: int, N: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chip SA offsets ~N(0,1) and fallback bits {0,1}, each [C, B, N],
    from the chips' SA keys [C, 2] (split once: offsets, then bits)."""
    ks = prng.split(sa_keys)
    eps_sa = prng.normal(ks[..., 0, :], (B, N))
    rnd = prng.bernoulli(ks[..., 1, :], 0.5, (B, N)).float()
    return eps_sa, rnd


def ensemble_apply_kernel(ens: ChipEnsemble, x_bits: torch.Tensor, *,
                          cfg: ni.NonidealConfig,
                          spec: MacroSpec = DEFAULT_MACRO,
                          sa_extra_units: float = 0.0, output: str = "binary",
                          per_chip_x: bool = False, impl: str = "kernel",
                          device=None) -> torch.Tensor:
    """Every chip of `ens` on x_bits -> [chips, B, n_out] in one launch.

    x_bits is [B, fan_in] shared by every chip, or [chips, B, fan_in] with
    `per_chip_x` (chip-diverged activations downstream of the first IRC
    layer).  `impl="kernel"` goes through `ops.irc_mvm_chips` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors);
    `impl="ref"` calls the plain version on any device, the route against
    which the kernel is held.  Single-shot accumulation and the analytic
    periphery only: the kernel's epilogue bakes both in."""
    if device is not None and not device.analytic_periphery:
        raise NotImplementedError(
            f"device model {device.name!r} has a non-analytic periphery; "
            "the fused kernel supports analytic-periphery backends only (the "
            "plain ensemble route comes with a later slice)")
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
                             rnd, params)


@dataclasses.dataclass(frozen=True)
class McConfig:
    """One ensemble sweep: population size, chunking, effect toggles, the
    reported quantiles and the device model (None: analytic).  The
    reference's accumulation/backend/calibration fields come with the
    slices that use them."""
    n_chips: int = 64
    chunk_size: int = 32
    cfg: ni.NonidealConfig = ni.NonidealConfig.all()
    quantiles: Tuple[float, ...] = DEFAULT_QUANTILES
    device: Optional[object] = None      # repro_torch.device.DeviceModel


@dataclasses.dataclass
class McResult:
    """Ensemble statistics for one sweep.

    `wall_s` covers the whole sweep; `compile_s` is the first chunk's wall
    (on the card it holds the kernel build and first-launch costs);
    `chips_per_sec` is the steady rate over the later chunks.
    `enqueue_s` is the host time spent sampling chips and enqueueing their
    forward (on the CPU the work itself runs there), `device_s` the time the
    host then sat blocked on device results, and `host_s` the host-side
    scoring time."""
    n_chips: int
    metrics: Dict[str, Dict[str, float]]
    per_chip: Dict[str, np.ndarray]
    wall_s: float
    chips_per_sec: float
    compile_s: float = 0.0
    enqueue_s: float = 0.0
    device_s: float = 0.0
    host_s: float = 0.0

    def summary_line(self, metric: str = "map50") -> str:
        """One-line mean±std + quantile report for `metric`."""
        m = self.metrics[metric]
        qs = ";".join(f"{k}={v:.4f}" for k, v in sorted(m.items())
                      if k.startswith("q"))
        return (f"{metric}={m['mean']:.4f}±{m['std']:.4f} "
                f"({qs}) over {self.n_chips} chips "
                f"[{self.chips_per_sec:.1f} chips/s steady, "
                f"first chunk {self.compile_s:.2f}s]")


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
