"""Device selection for the port's entry points.

Entry points that create tensors default to the card (`device="cuda"`) and
raise when there is none; the CPU runs only when the caller asks for it
(`device="cpu"`), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`torch.device(device)`, raising if it names CUDA and no card is
    visible (never a silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
