"""The detector QAT step shared by `quick_qat` and the MC CLI.

One step is (params, opt, images, targets, lr, key, ens_key) -> (params,
opt, loss): the loss through the detector's train mode, its gradient by
autograd through the straight-through estimators, then one AdamW update.
`train_chips=1` is the single-draw step (one surrogate-noise draw keyed
`key`; `ens_key` unused); `train_chips>=2` draws a deviation population
keyed `ens_key` from the current weights, runs `mode="train_ensemble"` and
averages the loss over the chips by folding them into the batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, tree_leaves,
                                     tree_map, tree_unflatten)

# Salt separating the chip-population key stream from the per-step noise
# stream (`fold_in(root, step)`), so one root key reproduces a whole run.
ENSEMBLE_KEY_STREAM = 0x0E25


def ensemble_key_for_step(key: torch.Tensor, step: int,
                          resample_every: int = 1) -> torch.Tensor:
    """Chip-population key for QAT step `step`:
    fold_in(fold_in(key, ENSEMBLE_KEY_STREAM), step // resample_every), so
    the dies stay frozen for `resample_every` steps and are then
    resampled."""
    if resample_every < 1:
        raise ValueError(f"resample_every must be >= 1, got "
                         f"{resample_every}")
    return prng.fold_in(prng.fold_in(key, ENSEMBLE_KEY_STREAM),
                        step // resample_every)


def make_det_qat_grad(det, *, train_chips: int = 1,
                      cfg_ni: Optional[ni.NonidealConfig] = None
                      ) -> Callable:
    """The loss and gradient of the detector QAT step for `det` (an
    `IRCDetector`): `(params, images, targets, key, ens_key) -> (loss,
    grads)`, grads a tree like params (zeros for the BN running stats,
    which the train modes do not read)."""
    from repro_torch.mc.detector_mc import build_train_ensemble
    from repro_torch.train.det_loss import yolo_loss
    if train_chips < 1:
        raise ValueError(f"train_chips must be >= 1, got {train_chips}")
    cfg_ni = ni.NonidealConfig.none() if cfg_ni is None else cfg_ni
    n_a, n_c = det.cfg.n_anchors, det.cfg.n_classes

    def loss_fn(p, images, targets, key, ens):
        if ens is None:
            pred = det.apply(p, images, mode="train", key=key, cfg_ni=cfg_ni)
            return yolo_loss(pred, targets, n_a, n_c)[0]
        pred = det.apply(p, images, mode="train_ensemble", key=key,
                         cfg_ni=cfg_ni, ensemble=ens)
        pred = pred.reshape((-1,) + pred.shape[2:])      # chips into batch
        tiled = {k: t.repeat((train_chips,) + (1,) * (t.ndim - 1))
                 for k, t in targets.items()}
        return yolo_loss(pred, tiled, n_a, n_c)[0]

    def grad_fn(params, images: torch.Tensor,
                targets: Dict[str, torch.Tensor], key: torch.Tensor,
                ens_key: torch.Tensor):
        ens = None
        if train_chips > 1:
            with torch.no_grad():
                ens = build_train_ensemble(ens_key, det, params, train_chips,
                                           cfg=cfg_ni)
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        with torch.enable_grad():
            loss = loss_fn(p, images, targets, key, ens)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    return grad_fn


def make_det_qat_step(det, *, train_chips: int = 1,
                      cfg_ni: Optional[ni.NonidealConfig] = None,
                      opt_cfg: AdamWConfig = AdamWConfig(weight_decay=1e-3)
                      ) -> Callable:
    """The detector QAT step `(params, opt, images, targets, lr, key,
    ens_key) -> (params, opt, loss)`: `make_det_qat_grad`, then one AdamW
    update of every leaf (the BN running stats by the weight decay alone,
    as in the reference)."""
    grad_fn = make_det_qat_grad(det, train_chips=train_chips, cfg_ni=cfg_ni)

    def qat_step(params, opt, images, targets, lr, key, ens_key):
        loss, grads = grad_fn(params, images, targets, key, ens_key)
        params, opt, _ = adamw_update(grads, opt, params, lr, opt_cfg)
        return params, opt, loss

    return qat_step

