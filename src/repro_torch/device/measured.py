"""Measured device backend: tabulated variation quantiles + I-V curves.

A real array's LRS spread rarely matches the closed-form fit exactly; this
backend draws variation through the inverse CDF of a measured quantile
table (z ~ N(0,1) -> u = Phi(z) -> linear interpolation of the tabulated
current factor at quantile u), so any digitized distribution plugs in
without a parametric fit.  The HRS leak comes from the measured LRS/HRS
I-V table at the spec's read voltage instead of the spec constant.

Tables are tuples (the model is a frozen, hashable dataclass) and ship as
JSON in `data/`, a byte-identical copy of the JAX package's dataset;
docs/device-models.md describes the format, which both packages read.
The mask is one draw of the die-sampling kernel's measured tail on the
card (`prng.measured`), bit-identical to the JAX package's jitted
`variation_mask`.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch import xla_order as xo
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.device.base import DeviceModel

#: packaged sample datasets live next to this module
DATA_DIR = Path(__file__).resolve().parent / "data"

#: the default packaged dataset (paper-scale 40nm RRAM sample table)
SAMPLE_DATASET = DATA_DIR / "sample_lrs_40nm.json"


@dataclasses.dataclass(frozen=True)
class MeasuredDeviceModel(DeviceModel):
    """Interpolating backend over a measured variation/I-V dataset.

    dataset:     dataset name (from the JSON), recorded in reports.
    var_q:       variation quantile grid, strictly increasing in (0, 1).
    var_factor:  LRS current factor at each quantile (median ~ 1.0).
    iv_v:        I-V voltage grid (V across the 1T1R cell).
    iv_lrs_ua:   measured LRS cell current (uA) at each voltage.
    iv_hrs_ua:   measured HRS cell current (uA) at each voltage.
    """

    dataset: str
    var_q: Tuple[float, ...]
    var_factor: Tuple[float, ...]
    iv_v: Tuple[float, ...]
    iv_lrs_ua: Tuple[float, ...]
    iv_hrs_ua: Tuple[float, ...]

    name = "measured"

    @classmethod
    def from_file(cls, path: Optional[Union[str, Path]] = None
                  ) -> "MeasuredDeviceModel":
        """Load a dataset JSON (default: the packaged sample table):
        {"name": ..., "variation": {"quantile": [...], "factor": [...]},
         "iv": {"v": [...], "i_lrs_ua": [...], "i_hrs_ua": [...]}}."""
        p = Path(path) if path is not None else SAMPLE_DATASET
        d = json.loads(p.read_text())
        q = tuple(float(v) for v in d["variation"]["quantile"])
        f = tuple(float(v) for v in d["variation"]["factor"])
        if len(q) != len(f) or len(q) < 2:
            raise ValueError(f"{p}: variation table needs >= 2 aligned "
                             f"(quantile, factor) points")
        if any(b <= a for a, b in zip(q, q[1:])):
            raise ValueError(f"{p}: variation quantiles must be strictly "
                             f"increasing")
        iv = d["iv"]
        return cls(dataset=str(d.get("name", p.stem)), var_q=q, var_factor=f,
                   iv_v=tuple(float(v) for v in iv["v"]),
                   iv_lrs_ua=tuple(float(v) for v in iv["i_lrs_ua"]),
                   iv_hrs_ua=tuple(float(v) for v in iv["i_hrs_ua"]))

    @property
    def table(self) -> prng.Table:
        """The variation table (quantiles, factors) as the measured tail
        takes it."""
        return self.var_q, self.var_factor

    def variation_factor(self, u: torch.Tensor) -> torch.Tensor:
        """Tabulated inverse CDF: quantile u in [0, 1] -> LRS current factor,
        linear between grid points and clamped to the end values beyond
        them (`jnp.interp`, in XLA's float32 order: `xla_order.interp`)."""
        xp, fp = (torch.tensor(t, dtype=torch.float32, device=u.device)
                  for t in prng.check_table(self.table))
        return xo.interp(u.float(), xp, fp)

    def variation_mask(self, key: torch.Tensor, shape,
                       spec: MacroSpec = DEFAULT_MACRO) -> torch.Tensor:
        """Per-cell mask by inverse-CDF sampling of the measured table: one
        standard normal per cell from `key`, as the analytic backend
        consumes it, so swapping backends shifts no other draw.  Key batch
        axes lead the result.  `spec.sigma_lrs` is ignored: the spread is
        the dataset's."""
        return prng.measured(key, shape, self.table)

    def hrs_leak_units(self, spec: MacroSpec = DEFAULT_MACRO) -> float:
        """HRS/LRS current ratio from the measured I-V table at the spec's
        read voltage (host-side float64 interpolation, a Python float)."""
        lrs = float(np.interp(spec.v_read, self.iv_v, self.iv_lrs_ua))
        hrs = float(np.interp(spec.v_read, self.iv_v, self.iv_hrs_ua))
        return hrs / lrs
