"""Short detector QAT loop shared by the MC CLI and the smoke run.

AdamW steps over the synthetic detection batches, enough training for
population-mAP sweeps to be ordering-meaningful.  `train_chips >= 2` trains
against a small chip population (deviation planes keyed by
`ensemble_key_for_step`, resampled every `resample_every` steps) instead of
one i.i.d. noise draw.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.train.steps import ensemble_key_for_step, make_det_qat_step


def batch_tensors(batch, device: torch.device):
    """A `DetBatch`'s images and YOLO targets as tensors on `device`."""
    images = torch.from_numpy(batch.images).to(device)
    targets = {k: torch.from_numpy(v).to(device)
               for k, v in batch.targets.items()}
    return images, targets


def quick_qat(det, data, steps: int, batch: int, *, lr: float = 3e-3,
              weight_decay: float = 1e-3, seed: int = 0, data_seed: int = 1,
              key: Optional[torch.Tensor] = None, train_chips: int = 1,
              resample_every: int = 1, cfg_ni=None,
              device: DeviceLike = "cuda"):
    """Train `det` from `init(PRNGKey(seed))` for `steps` AdamW steps on
    `data` and return the params, on `device` (the card unless the caller
    asks for the CPU).

    `key` (default PRNGKey(data_seed)) is the run's one root: step s draws
    its surrogate noise with fold_in(key, s) and, for `train_chips >= 2`,
    its chip population with `ensemble_key_for_step(key, s,
    resample_every)`."""
    dev = resolve_device(device)
    params = det.init(prng.PRNGKey(seed, device=dev), device=dev)
    opt = adamw_init(params)
    step = make_det_qat_step(det, train_chips=train_chips, cfg_ni=cfg_ni,
                             opt_cfg=AdamWConfig(weight_decay=weight_decay))
    root = prng.PRNGKey(data_seed, device=dev) if key is None else key
    lr32 = torch.tensor(lr, dtype=torch.float32, device=dev)
    for s in range(steps):
        images, targets = batch_tensors(data.batch_for_step(s, batch), dev)
        params, opt, _ = step(params, opt, images, targets, lr32,
                              prng.fold_in(root, s),
                              ensemble_key_for_step(root, s, resample_every))
    return params
