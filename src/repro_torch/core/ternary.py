"""Binary/ternary quantizers (paper Sec. IV-B), hard forward only.

The proposed design uses ternary weights (-1, 0, +1) regulated to 20/60/20
per filter group and binary {0,1} activations.  Nothing in this slice takes
a gradient, so there is no straight-through estimator here.
"""
from __future__ import annotations

import torch


def _sorted_threshold(w: torch.Tensor, frac: float, axis) -> torch.Tensor:
    """frac-quantile by sort + static index k = int(frac * (n - 1) + 0.5),
    over the whole tensor (`axis=None`) or per group over `axis`, with the
    reduced axes kept as size-1 dims."""
    w = w.detach()
    if axis is None:
        ws = torch.sort(w.reshape(-1)).values
        k = min(int(frac * (ws.shape[0] - 1) + 0.5), ws.shape[0] - 1)
        return ws[k]
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % w.ndim for a in axes)
    keep = [a for a in range(w.ndim) if a not in axes]
    wt = w.permute(keep + list(axes))
    lead = wt.shape[:len(keep)]
    ws = torch.sort(wt.reshape(lead + (-1,)), dim=-1).values
    k = min(int(frac * (ws.shape[-1] - 1) + 0.5), ws.shape[-1] - 1)
    t = ws[..., k]
    shape = [1] * w.ndim
    for a in keep:
        shape[a] = w.shape[a]
    return t.reshape(shape)


def ternary_quantize(w: torch.Tensor, lo_frac: float = 0.2,
                     hi_frac: float = 0.2, axis=None) -> torch.Tensor:
    """Quantile-regulated ternary quantization to {-1, 0, +1}: the per-group
    `lo_frac` / `1 - hi_frac` quantiles are the thresholds."""
    t_lo = _sorted_threshold(w, lo_frac, axis)
    t_hi = _sorted_threshold(w, 1.0 - hi_frac, axis)
    one = torch.ones_like(w)
    return torch.where(w <= t_lo, -one,
                       torch.where(w >= t_hi, one, torch.zeros_like(w)))


def binary_quantize(w: torch.Tensor) -> torch.Tensor:
    """Sign binarization to {-1, +1} (baseline design)."""
    one = torch.ones_like(w)
    return torch.where(w >= 0, one, -one)


def binary_activation(x: torch.Tensor) -> torch.Tensor:
    """Step activation to {0, 1} (word-line on/off)."""
    return (x > 0).to(x.dtype)
