"""Train, eval and decode steps of the LM, and the detector QAT step.

`make_train_step(lm, ...)` returns `(state, batch) -> (state, metrics)`:
the loss and its gradient by autograd under the reference's per-layer
remat, gradient accumulation over micro-slices of the batch, global-norm
clipping and AdamW at `lr_fn(step)`.  The step is functional: it returns
a new state and leaves the old one as it was (the trainer drops the old
state after each step, where the reference donates it to the jitted
step).  `TrainState` walks as the reference registers it, so a state
saves and restores through `repro_torch.ckpt` under the reference's key
paths (`params/...`, `opt/m/...`, `opt/v/...`, `opt/step`, `step`).

The detector QAT step is (params, opt, images, targets, lr, key, ens_key)
-> (params, opt, loss): the loss through the detector's train mode, its
gradient by autograd through the straight-through estimators, then one
AdamW update.  `train_chips=1` is the single-draw step (one surrogate-noise
draw keyed `key`; `ens_key` unused); `train_chips>=2` draws a deviation
population keyed `ens_key` from the current weights, runs
`mode="train_ensemble"` and averages the loss over the chips by folding
them into the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.models.common import const
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map, tree_unflatten)
from repro_torch.optim.schedule import warmup_step_decay
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.sharding.dtensor import sharded_context

PyTree = Any


@dataclasses.dataclass
class TrainState:
    """Params, AdamW state ({"m", "v", "step"}) and the step counter (an
    int32 scalar tensor); its children walk in `TREE_FIELDS` order."""
    TREE_FIELDS: ClassVar[Tuple[str, ...]] = ("params", "opt", "step")
    params: PyTree
    opt: PyTree
    step: torch.Tensor


def init_train_state(lm, key: torch.Tensor,
                     device: DeviceLike = "cuda") -> TrainState:
    """`lm.init(key)` on `device`, zero moments, step 0."""
    dev = resolve_device(device)
    params = lm.init(key, device=dev)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_train_state(lm) -> TrainState:
    """The state as `meta` tensors (no allocation)."""
    params = lm.abstract_params()
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    i32 = lambda: torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=params,
                      opt={"m": tree_map(f32, params),
                           "v": tree_map(f32, params), "step": i32()},
                      step=i32())


def train_state_axes(lm) -> TrainState:
    """Logical axes of the state: the moments share the params' axes; the
    step counters have none."""
    axes = lm.logical_axes()
    return TrainState(params=axes, opt={"m": axes, "v": axes, "step": ()},
                      step=())


def _with_grads(loss_fn: Callable, params: PyTree) -> Tuple:
    """(loss, aux, grads) of `loss_fn(params) -> (loss, aux)` by autograd:
    grads a tree like params, each leaf in its param's dtype (zeros for a
    leaf the loss does not read)."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, live))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def value_and_grad(lm, params: PyTree, batch: Dict[str, torch.Tensor], *,
                   remat: str = "block", scan_layers: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """(loss, metrics, grads) of `lm.loss` at `params` (`_with_grads`)."""
    loss, metrics, grads = _with_grads(
        lambda p: lm.loss(p, batch, remat=remat, scan_layers=scan_layers),
        params)
    return loss, {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(lm, *, opt_cfg: AdamWConfig = AdamWConfig(),
                    lr_fn: Optional[Callable] = None, remat: str = "block",
                    microbatch: int = 1, scan_layers: bool = True,
                    scan_microbatches: bool = True
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The LM train step.  `microbatch > 1` accumulates the gradients of
    the batch's leading micro-slices, in order, into float32 zeros, then
    divides by `microbatch` (the loss likewise); the metrics are the last
    micro-slice's, with the mean loss, `grad_norm` and `lr`.  `lr_fn`
    defaults to `warmup_step_decay`.  `scan_layers` and
    `scan_microbatches` are accepted for the reference's signature: the
    loops over layers and micro-slices are always unrolled here."""
    del scan_microbatches
    lr_fn = lr_fn or warmup_step_decay
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")

    def grad_of(params, batch):
        return value_and_grad(lm, params, batch, remat=remat,
                              scan_layers=scan_layers)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        # on a mesh (`LM.use_mesh`), plain tensors (the backward's saved
        # tables, the learning rate) count as replicated
        with sharded_context(getattr(lm, "sharded", False)):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatch > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatch:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{microbatch} micro-slices")
            per = rows // microbatch
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state.step.device)
            for i in range(microbatch):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                l, metrics, g = grad_of(state.params, mb)
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                del g
                loss_sum = loss_sum + l
            grads = tree_map(lambda g: g.div_(const(microbatch, g)), grads)
            loss = loss_sum / const(microbatch, loss_sum)
        else:
            loss, metrics, grads = grad_of(state.params, batch)
        lr = lr_fn(state.step)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, lr, opt_cfg)
        del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        metrics["loss"] = loss
        # keys sorted, as the reference's jitted step returns its dict
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), dict(sorted(metrics.items()))

    return train_step


def make_eval_step(lm) -> Callable:
    """(params, batch) -> the loss's metrics, without remat or autograd."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss(params, batch, remat="none")
        return metrics
    return eval_step


def make_decode_step(lm) -> Callable:
    """(params, tokens, cache) -> `lm.decode_step`'s (logits, cache)."""
    def decode_step(params, tokens, cache):
        return lm.decode_step(params, tokens, cache)
    return decode_step


# ------------------------------------------------------------- detector QAT

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
        loss, _, grads = _with_grads(
            lambda p: (loss_fn(p, images, targets, key, ens), None), params)
        return loss, grads

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

