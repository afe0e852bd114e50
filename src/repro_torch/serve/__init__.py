"""Population-aware detector serving: an async request queue with admission
control, waves of requests onto `committee_wave_forward`, and per-request
committee mean/std/quantile confidence.

CLI: `python -m repro_torch.launch.serve --network detector`.
"""
from repro_torch.serve.detector import (DetectorServeEngine, Detection,
                                        DetectionResponse, ServeQueueFull,
                                        PAD_REQUEST_ID)

__all__ = ["DetectorServeEngine", "Detection", "DetectionResponse",
           "ServeQueueFull", "PAD_REQUEST_ID"]
