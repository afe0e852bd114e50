"""Selective SSM (Mamba-style) branch of the hybrid (hymba) block (the
reference's `repro.models.ssm`): in-proj -> depthwise conv -> selective scan
(data-dependent dt/B/C, diagonal A) -> gated out-proj.

Training/prefill runs the reference's associative scan
(`associative_scan`, the recursion of `jax.lax.associative_scan`: O(S)
elementwise work in O(log S) levels of a few launches each), its combine's
multiply-add fused as XLA fuses it, so the states are the jitted
reference's bit for bit on the CPU; decode is an O(1) state update, the
part serving runs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch import xla_order
from repro_torch.models.common import ParamSpec, const, silu
from repro_torch.models.lm_config import LMConfig
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.sharding.dtensor import local_apply


def ssm_specs(cfg: LMConfig) -> Dict[str, ParamSpec]:
    d, di, n = cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state
    pd = cfg.pdtype
    return {
        "w_in": ParamSpec((d, 2 * di), ("embed", "heads_qkv"), dtype=pd),
        "conv": ParamSpec((cfg.ssm_conv, di), (None, "heads_qkv"),
                          init="scaled", scale=1.0, dtype=pd),
        "w_dt": ParamSpec((di, di), ("heads_qkv", "heads_qkv"),
                          init="scaled", scale=0.1, dtype=pd),
        "dt_bias": ParamSpec((di,), ("heads_qkv",), init="zeros", dtype=pd),
        "w_bc": ParamSpec((di, 2 * n), ("heads_qkv", None), dtype=pd),
        "a_log": ParamSpec((di, n), ("heads_qkv", None), init="zeros",
                           dtype=torch.float32),
        "d_skip": ParamSpec((di,), ("heads_qkv",), init="ones", dtype=pd),
        "w_out": ParamSpec((di, d), ("heads_qkv", "embed"), dtype=pd),
    }


def _conv_scan(x: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over seq: x [B,S,di], conv_w [K,di]; tap i
    multiplies the token i steps back, summed from i = 0 up.  DTensors
    (`LM.use_mesh`) run it on each rank's shard (`parallel.conv_scan`)."""
    if hasattr(x, "device_mesh"):
        from repro_torch.sharding import parallel
        return parallel.conv_scan(_conv_scan, x, conv_w)
    K = conv_w.shape[0]
    S = x.shape[1]
    out = None
    for i in range(K):
        p = torch.nn.functional.pad(x, (0, 0, K - 1 - i, i))[:, :S, :]
        term = p * conv_w[K - 1 - i]
        out = term if out is None else out + term
    return silu(out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.logaddexp(x, const(0.0, x))


def _keep(t: torch.Tensor, axes) -> torch.Tensor:
    return t


# [B,S,di] with the inner dim over "model" (TP on a mesh)
_INNER = ("act_batch", None, "heads_qkv")
_WHOLE = ("act_batch", None, None)


def _split_in(h: torch.Tensor, di: int, c) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The in-projection [B,S,2di] split into x and the gate z.  On a mesh
    (`c`, `LM._constrain`) it is gathered whole first and each half then
    sharded over "model" (a local slice): the values stay those of one
    device."""
    h = c(h, _WHOLE)
    return c(h[..., :di], _INNER), c(h[..., di:], _INNER)


def _selective_terms(params, xc: torch.Tensor, cfg: LMConfig, c=_keep):
    """Common dt/B/C/A terms.  xc [B,S,di] (post-conv).  `c` pins the
    placements on a mesh: dt sharded like xc, B and C whole."""
    n = cfg.ssm_state
    dt = _softplus(c(xc @ params["w_dt"].to(xc.dtype), _INNER)
                   + params["dt_bias"].to(xc.dtype))             # [...,di]
    bc = c(xc @ params["w_bc"].to(xc.dtype), _WHOLE)             # [...,2n]
    b, c = bc[..., :n], bc[..., n:]
    a = -torch.exp(params["a_log"])                              # [di,n] f32
    dt32 = dt.float()
    a_bar = torch.exp(dt32[..., None] * a)                       # [...,di,n]
    bx = (dt32[..., None] * b.float()[..., None, :]
          * xc.float()[..., None])                               # [...,di,n]
    return a_bar, bx, c, dt


def _slice(x: torch.Tensor, axis: int, start: int, stop=None,
           step: int = 1) -> torch.Tensor:
    """`lax.slice_in_dim` (a view)."""
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                axis: int) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along `axis`; `even` is as long as
    `odd` or one longer."""
    n = odd.shape[axis]
    pairs = torch.stack((_slice(even, axis, 0, n), odd), dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if even.shape[axis] > n:
        out = torch.cat((out, _slice(even, axis, n)), dim=axis)
    return out


def associative_scan(fn: Callable[[List, List], List],
                     elems: Sequence[torch.Tensor],
                     axis: int) -> List[torch.Tensor]:
    """Inclusive scan of the tuple `elems` along `axis` under the
    associative `fn(left, right)`, by `jax.lax.associative_scan`'s
    recursion: combine neighbouring pairs, scan the half, then combine
    each odd result with the next element, so every output is made by the
    same combines in the same order as the reference's."""
    n = elems[0].shape[axis]
    if n < 2:
        return list(elems)
    reduced = fn([_slice(e, axis, 0, n - 1, 2) for e in elems],
                 [_slice(e, axis, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([_slice(e, axis, 0, -1) for e in odd],
                  [_slice(e, axis, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_slice(e, axis, 2, None, 2) for e in elems])
    even = [torch.cat((_slice(e, axis, 0, 1), r), dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


class _Fma(torch.autograd.Function):
    """float32 a * b + c rounded once (`xla_order.fma`: one launch of the
    `xla_fma` kernel on the card, its plain version on the CPU), as XLA
    contracts the reference's combine; the product rule backward."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return xla_order.fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def _combine(left: List[torch.Tensor],
             right: List[torch.Tensor]) -> List[torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t composed: (al ar, bl ar + br), the second
    fused as XLA fuses it."""
    al, bl = left
    ar, br = right
    return [al * ar, _Fma.apply(bl, ar, br)]


def ssm_branch(params, x: torch.Tensor, cfg: LMConfig,
               constrain=None) -> torch.Tensor:
    """Training/prefill: x [B,S,D] -> [B,S,D] via the associative scan.
    `constrain` (`LM._constrain` on a mesh) runs the branch tensor-parallel
    over its inner dim."""
    di = cfg.d_inner_ssm
    h = x @ params["w_in"].to(x.dtype)                           # [B,S,2di]
    if constrain is None:
        xin, z = h[..., :di], h[..., di:]
    else:
        xin, z = _split_in(h, di, constrain)
    xc = _conv_scan(xin, params["conv"].to(x.dtype))
    a_bar, bx, c, _ = _selective_terms(params, xc, cfg,
                                       constrain or _keep)       # [B,S,di,n]
    _, hs = associative_scan(_combine, (a_bar, bx), axis=1)
    y = torch.einsum("bsdn,bsn->bsd", hs, c.float()).to(x.dtype)
    y = y + params["d_skip"].to(x.dtype) * xc
    y = y * silu(z)
    return y @ params["w_out"].to(x.dtype)


def ssm_decode(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: LMConfig, constrain=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode.  x [B,1,D]; state: conv window [B,K-1,di] and
    ssm state h [B,di,n] (f32); `constrain` as in `ssm_branch`."""
    di = cfg.d_inner_ssm
    hproj = x @ params["w_in"].to(x.dtype)
    if constrain is None:
        xin, z = hproj[..., :di], hproj[..., di:]                # [B,1,di]
    else:
        xin, z = _split_in(hproj, di, constrain)
    window = torch.cat([state["conv"], xin], dim=1)              # [B,K,di]
    # prefill's causal conv puts conv[0] on the current token; the window
    # is ordered oldest->newest, so the taps are flipped to match
    conv_w = local_apply(lambda c: torch.flip(c, dims=(0,)),
                         params["conv"]).to(x.dtype)
    xc = silu(torch.einsum("bkd,kd->bd", window, conv_w))[:, None, :]
    a_bar, bx, c, _ = _selective_terms(params, xc, cfg,
                                       constrain or _keep)       # [B,1,di,n]
    h_new = state["h"] * a_bar[:, 0] + bx[:, 0]                  # [B,di,n]
    y = torch.einsum("bdn,bn->bd", h_new,
                     c[:, 0].float())[:, None, :].to(x.dtype)
    y = y + params["d_skip"].to(x.dtype) * xc
    y = y * silu(z)
    out = y @ params["w_out"].to(x.dtype)
    return out, {"conv": window[:, 1:], "h": h_new}


def init_ssm_state(cfg: LMConfig, batch: int, n_layers: int,
                   device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    di, n, k = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((n_layers, batch, k - 1, di), dtype=cfg.adtype,
                            device=dev),
        "h": torch.zeros((n_layers, batch, di, n), dtype=torch.float32,
                         device=dev),
    }
