"""Batched serving engines:

  ServeEngine            LM slot-wave engine: fixed-slot batched decode
  DetectorServeEngine    population-aware detector serving: an async request
                         queue with admission control, waves of requests
                         onto `committee_wave_forward`, and per-request
                         committee mean/std/quantile confidence

CLI: `python -m repro_torch.launch.serve` (`--network lm`, the default, or
`--network detector`).
"""
from repro_torch.serve.engine import ServeEngine, GenerationResult
from repro_torch.serve.detector import (DetectorServeEngine, Detection,
                                        DetectionResponse, ServeQueueFull,
                                        PAD_REQUEST_ID)

__all__ = ["ServeEngine", "GenerationResult", "DetectorServeEngine",
           "Detection", "DetectionResponse", "ServeQueueFull",
           "PAD_REQUEST_ID"]
