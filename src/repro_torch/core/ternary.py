"""Binary/ternary quantizers with straight-through estimators (paper
Sec. IV-B).

The proposed design uses ternary weights (-1, 0, +1) regulated to 20/60/20
per filter group and binary {0,1} activations; the baseline binary +-1
weights.  Every quantizer returns `soft + (hard - soft).detach()`: the hard
value forward (rounded in float32 as the reference rounds it, so a +-1 can
come out an ulp off), the soft value's gradient backward.  The same
functions serve QAT and inference.
"""
from __future__ import annotations

import torch


def _ste(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """Hard value forward, soft gradient backward: soft + (hard - soft),
    each step rounded to float32 (not `hard` itself)."""
    return soft + (hard - soft).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`: maximum, then minimum, each splitting its gradient in
    half at a tie as the reference's do (`torch.clamp` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


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
    `lo_frac` / `1 - hi_frac` quantiles are the thresholds; clipped-identity
    STE."""
    t_lo = _sorted_threshold(w, lo_frac, axis)
    t_hi = _sorted_threshold(w, 1.0 - hi_frac, axis)
    one = torch.ones_like(w)
    hard = torch.where(w <= t_lo, -one,
                       torch.where(w >= t_hi, one, torch.zeros_like(w)))
    return _ste(hard, _clip(w, -1.0, 1.0))


def binary_quantize(w: torch.Tensor) -> torch.Tensor:
    """Sign binarization to {-1, +1} (baseline design), clipped-identity
    STE."""
    one = torch.ones_like(w)
    return _ste(torch.where(w >= 0, one, -one), _clip(w, -1.0, 1.0))


def ternary_fractions(w_t: torch.Tensor) -> torch.Tensor:
    """Fractions of (-1, 0, +1) in quantized weights."""
    n = w_t.numel()
    neg = torch.sum(w_t < -0.5).float() / n
    pos = torch.sum(w_t > 0.5).float() / n
    return torch.stack([neg, 1.0 - neg - pos, pos])


def distribution_regularizer(w: torch.Tensor, lo_frac: float = 0.2,
                             hi_frac: float = 0.2) -> torch.Tensor:
    """Soft penalty that keeps the latent weights spread, so the quantile
    thresholds stay apart: (1 - mean|w - mean w|)^2 * (lo + hi)."""
    spread = torch.mean(torch.abs(w - torch.mean(w)))
    return torch.square(1.0 - spread) * (lo_frac + hi_frac)


# ------------------------------------------------------------------ activations

def binary_activation(x: torch.Tensor) -> torch.Tensor:
    """Step activation to {0, 1} (word-line on/off), hard-tanh-window STE:
    the gradient is 0.5 where |x| < 1."""
    hard = (x > 0).to(x.dtype)
    return _ste(hard, _clip(0.5 * (x + 1.0), 0.0, 1.0))


def soft_sa_output(diff: torch.Tensor, beta: float = 4.0) -> torch.Tensor:
    """The binary SA with a sigmoid(beta * diff) surrogate gradient."""
    hard = (diff > 0).to(diff.dtype)
    return _ste(hard, torch.sigmoid(beta * diff))
