"""Device-model backends (the physics seam).

  DeviceModel            the interface
  AnalyticDeviceModel    the paper's closed forms (the default)
  MeasuredDeviceModel    tabulated variation/I-V datasets
  RetentionDrift         time-parameterized aging wrapper (t_days)
  get_device_model       name -> model (the CLI's registry)
  default_device         resolve `device=None` to the analytic singleton
"""
from repro_torch.device.base import DeviceModel
from repro_torch.device.analytic import (ANALYTIC_DEVICE, AnalyticDeviceModel,
                                         default_device)
from repro_torch.device.measured import MeasuredDeviceModel, SAMPLE_DATASET
from repro_torch.device.retention import RetentionDrift
from repro_torch.device.registry import DEVICE_MODELS, get_device_model

__all__ = ["DeviceModel", "ANALYTIC_DEVICE", "AnalyticDeviceModel",
           "default_device", "MeasuredDeviceModel", "SAMPLE_DATASET",
           "RetentionDrift", "DEVICE_MODELS", "get_device_model"]
