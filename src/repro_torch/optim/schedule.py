"""LR schedules.  `warmup_step_decay` is the paper's detector schedule:
warm up 1e-5 -> 1e-4 over the first 5 epochs, step down to 1e-5 / 1e-6 at
epochs 80 / 110 (Sec. V-A), expressed in steps, in float32."""
from __future__ import annotations

import torch


def warmup_step_decay(step, base_lr=1e-4, warmup_start=1e-5,
                      warmup_steps=500, decay_points=((8000, 1e-5),
                                                      (11000, 1e-6))
                      ) -> torch.Tensor:
    """The learning rate at `step` (an int or a tensor) as a float32
    tensor: linear warm-up, then the last decay point passed."""
    t = torch.as_tensor(step, dtype=torch.float32)
    frac = torch.clamp(t / max(warmup_steps, 1), 0.0, 1.0)
    lr = warmup_start + frac * (base_lr - warmup_start)
    for boundary, value in decay_points:
        lr = torch.where(t >= boundary, t.new_tensor(value), lr)
    return lr
