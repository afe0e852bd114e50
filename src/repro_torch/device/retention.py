"""Retention/drift timelines: time-parameterize any device backend.

Programmed LRS cells drift toward higher resistance over deployment time
(power-law decay, G(t) = G0 (1 + t/t0)^-nu) and the cell-to-cell spread
widens as cells drift at different rates.  `RetentionDrift` wraps any
`DeviceModel` with both effects at age `t_days`, so sweeps over a list of
ages give "mAP after N days" curves from the same chip key stream
(`launch.mc --t-days 0,30,365`).

At `t_days=0` the wrapper is exactly the identity: it returns the base
backend's mask untouched and draws nothing more.  The per-cell drift draw
is keyed by `fold_in(key, _DRIFT_SALT)`, so the base backend's use of `key`
is unchanged and chip c's day-0 planes stay inside its own aging curve.
Every mask is bit-identical to the JAX package's jitted `RetentionDrift`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.device.base import DeviceModel

#: key-domain salt separating the drift draw from the base variation draw
_DRIFT_SALT = 0x0D21F7


@dataclasses.dataclass(frozen=True)
class RetentionDrift(DeviceModel):
    """Age a device backend by `t_days`.

    base:        the wrapped backend (analytic, measured, ...).
    t_days:      deployment age in days (0 = programming day, identity).
    t0_days:     retention time constant of the power-law decay.
    drift_nu:    decay exponent: the median LRS current falls as
                 (1 + t/t0)^-nu (~3% at 30 days, ~7% at a year).
    spread_rate: log-space sigma growth per log-time unit, the per-cell
                 drift dispersion sigma_d(t) = spread_rate * log1p(t/t0).

    HRS cells are non-formed and stable, so the leak and the periphery
    hooks are the base backend's; aging acts on the LRS variation only.
    """

    base: DeviceModel
    t_days: float = 0.0
    t0_days: float = 1.0
    drift_nu: float = 0.05
    spread_rate: float = 0.02

    @property
    def name(self) -> str:
        """Backend id with the age stamped in (for reports)."""
        return f"{self.base.name}@t{self.t_days:g}d"

    @property
    def analytic_periphery(self) -> bool:
        """Aging touches the device planes only: the base's periphery."""
        return self.base.analytic_periphery

    def _decay(self) -> float:
        """Median current-retention factor at age t (Python float)."""
        return float((1.0 + self.t_days / self.t0_days) ** (-self.drift_nu))

    def _spread_sigma(self) -> float:
        """Log-space sigma of the per-cell drift dispersion at age t."""
        return float(self.spread_rate * math.log1p(self.t_days / self.t0_days))

    def variation_mask(self, key: torch.Tensor, shape,
                       spec: MacroSpec = DEFAULT_MACRO) -> torch.Tensor:
        """The base mask times the age-t drift, mask * (decay * exp(sigma_d
        * z)) in that order, as the reference's jit multiplies: z drawn
        under `fold_in(key, _DRIFT_SALT)` as a log-normal mask at sigma_d
        (`prng.lognormal`), decay rounded to float32.  At t_days = 0 the
        base mask itself, with no further draw or op."""
        mask = self.base.variation_mask(key, shape, spec)
        if self.t_days == 0.0:
            return mask
        drift = prng.lognormal(prng.fold_in(key, _DRIFT_SALT), shape,
                               self._spread_sigma())
        return mask * (float(np.float32(self._decay())) * drift)

    def hrs_leak_units(self, spec: MacroSpec = DEFAULT_MACRO) -> float:
        """HRS cells are stable: the base backend's leak."""
        return self.base.hrs_leak_units(spec)

    def sa_offset_sigma(self, p: torch.Tensor, spec: MacroSpec = DEFAULT_MACRO,
                        extra_units: float = 0.0) -> torch.Tensor:
        """Periphery does not age in this model: the base's."""
        return self.base.sa_offset_sigma(p, spec, extra_units)

    def ir_drop_factors(self, block_currents: torch.Tensor,
                        spec: MacroSpec = DEFAULT_MACRO,
                        axis: int = -1) -> torch.Tensor:
        """Wire parasitics do not age in this model: the base's."""
        return self.base.ir_drop_factors(block_currents, spec, axis=axis)
