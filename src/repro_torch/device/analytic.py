"""The analytic device backend: the paper's closed-form models."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.device.base import DeviceModel


@dataclasses.dataclass(frozen=True)
class AnalyticDeviceModel(DeviceModel):
    """Log-normal variation at the spec's sigma + the spec's HRS leak."""

    name = "analytic"

    def variation_mask(self, key: torch.Tensor, shape,
                       spec: MacroSpec = DEFAULT_MACRO) -> torch.Tensor:
        """Log-normal per-cell mask at the operating-point sigma."""
        return ni.sample_variation_mask(key, shape, spec.sigma_lrs)

    def hrs_leak_units(self, spec: MacroSpec = DEFAULT_MACRO) -> float:
        """The spec's HRS leak constant (~1e-4 units)."""
        return float(spec.hrs_leak)


#: the process-wide analytic singleton every `device=None` seam resolves to
ANALYTIC_DEVICE = AnalyticDeviceModel()
