"""Device-model backends (this slice: the analytic closed forms only; the
measured and retention backends come in a later slice)."""
from repro_torch.device.base import DeviceModel
from repro_torch.device.analytic import ANALYTIC_DEVICE, AnalyticDeviceModel

__all__ = ["DeviceModel", "ANALYTIC_DEVICE", "AnalyticDeviceModel"]
