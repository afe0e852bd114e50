"""`DeviceModel` — the seam between RRAM device physics and its consumers
(crossbar sim, MC engine, detector).

Device-side hooks (`variation_mask`, `hrs_leak_units`) are abstract;
periphery hooks (`sa_offset_sigma`, `ir_drop_factors`) default to the paper's
circuit models.  A backend that overrides the periphery must clear
`analytic_periphery`, so the fused kernel (whose epilogue bakes in the
analytic periphery) refuses it instead of computing the wrong thing.  Hooks
are pure functions of their inputs: random draws consume only the key given.
"""
from __future__ import annotations

import abc

import torch

from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO


class DeviceModel(abc.ABC):
    """Where conductance planes and periphery statistics come from."""

    #: short backend identifier, recorded in reports
    name: str = "base"

    @property
    def analytic_periphery(self) -> bool:
        """True while SA-offset/IR-drop hooks are the analytic closed forms
        (the contract the fused kernel epilogue bakes in)."""
        return True

    @abc.abstractmethod
    def variation_mask(self, key: torch.Tensor, shape,
                       spec: MacroSpec = DEFAULT_MACRO) -> torch.Tensor:
        """Per-cell multiplicative current mask for programmed LRS cells,
        drawn once per chip; key batch axes lead the result."""

    @abc.abstractmethod
    def hrs_leak_units(self, spec: MacroSpec = DEFAULT_MACRO) -> float:
        """HRS (non-formed cell) leak current in LRS units, a Python float."""

    def sa_offset_sigma(self, p: torch.Tensor, spec: MacroSpec = DEFAULT_MACRO,
                        extra_units: float = 0.0) -> torch.Tensor:
        """Std of the input-referred SA offset at activated-LRS count `p`:
        half the required difference g(p) (+ the tolerance margin)."""
        return 0.5 * (ni.sa_required_diff(p, spec) + extra_units)

    def ir_drop_factors(self, block_currents: torch.Tensor,
                        spec: MacroSpec = DEFAULT_MACRO,
                        axis: int = -1) -> torch.Tensor:
        """Per-block current-retention factors: the linear wire-drop model."""
        return ni.ir_drop_factors(block_currents, spec.ir_alpha, axis=axis)
