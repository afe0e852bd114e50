"""Named device-model construction for the CLIs and reports.

`get_device_model("measured", t_days=30)` is the one-liner behind
`launch.mc --device-model measured --t-days 30`: resolve the backend name,
optionally wrap it in a `RetentionDrift` timeline.  Library code takes
`device=` objects directly.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from repro_torch.device.analytic import ANALYTIC_DEVICE
from repro_torch.device.base import DeviceModel
from repro_torch.device.measured import MeasuredDeviceModel
from repro_torch.device.retention import RetentionDrift

#: backend names accepted by `get_device_model` / `launch.mc --device-model`
DEVICE_MODELS = ("analytic", "measured")


def get_device_model(name: str = "analytic", t_days: float = 0.0, *,
                     data: Optional[Union[str, Path]] = None) -> DeviceModel:
    """Build a device model by name, aged by `t_days`.

    name:   "analytic" (the paper's closed forms) or "measured" (the
            packaged sample dataset, or `data=` for another JSON).
    t_days: deployment age; non-zero wraps the backend in `RetentionDrift`
            (0 returns the bare backend).
    """
    if name == "analytic":
        base: DeviceModel = ANALYTIC_DEVICE
    elif name == "measured":
        base = MeasuredDeviceModel.from_file(data)
    else:
        raise ValueError(f"unknown device model {name!r} "
                         f"(choices: {', '.join(DEVICE_MODELS)})")
    if t_days:
        return RetentionDrift(base=base, t_days=float(t_days))
    return base
