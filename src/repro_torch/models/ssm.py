"""Selective SSM (Mamba-style) branch of the hybrid (hymba) block (the
reference's `repro.models.ssm`): in-proj -> depthwise conv -> selective scan
(data-dependent dt/B/C, diagonal A) -> gated out-proj.

Training/prefill scans the sequence step by step (the reference uses an
associative scan, which rounds in another order: `ssm_branch` agrees within
a tolerance, not bit for bit); decode is an O(1) state update, the part
serving runs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ParamSpec, const, silu
from repro_torch.models.lm_config import LMConfig
from repro_torch.runtime import DeviceLike, resolve_device


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
    multiplies the token i steps back, summed from i = 0 up."""
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


def _selective_terms(params, xc: torch.Tensor, cfg: LMConfig):
    """Common dt/B/C/A terms.  xc [..., di] (post-conv)."""
    n = cfg.ssm_state
    dt = _softplus(xc @ params["w_dt"].to(xc.dtype)
                   + params["dt_bias"].to(xc.dtype))             # [...,di]
    bc = xc @ params["w_bc"].to(xc.dtype)                        # [...,2n]
    b, c = bc[..., :n], bc[..., n:]
    a = -torch.exp(params["a_log"])                              # [di,n] f32
    dt32 = dt.float()
    a_bar = torch.exp(dt32[..., None] * a)                       # [...,di,n]
    bx = (dt32[..., None] * b.float()[..., None, :]
          * xc.float()[..., None])                               # [...,di,n]
    return a_bar, bx, c, dt


def ssm_branch(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Training/prefill: x [B,S,D] -> [B,S,D], the scan step by step."""
    di = cfg.d_inner_ssm
    h = x @ params["w_in"].to(x.dtype)                           # [B,S,2di]
    xin, z = h[..., :di], h[..., di:]
    xc = _conv_scan(xin, params["conv"].to(x.dtype))
    a_bar, bx, c, _ = _selective_terms(params, xc, cfg)          # [B,S,di,n]
    state = torch.zeros_like(bx[:, 0])
    hs = []
    for t in range(x.shape[1]):
        state = state * a_bar[:, t] + bx[:, t]
        hs.append(state)
    hs = torch.stack(hs, dim=1)
    y = torch.einsum("bsdn,bsn->bsd", hs, c.float()).to(x.dtype)
    y = y + params["d_skip"].to(x.dtype) * xc
    y = y * silu(z)
    return y @ params["w_out"].to(x.dtype)


def ssm_decode(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: LMConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode.  x [B,1,D]; state: conv window [B,K-1,di] and
    ssm state h [B,di,n] (f32)."""
    di = cfg.d_inner_ssm
    hproj = x @ params["w_in"].to(x.dtype)
    xin, z = hproj[..., :di], hproj[..., di:]                    # [B,1,di]
    window = torch.cat([state["conv"], xin], dim=1)              # [B,K,di]
    # prefill's causal conv puts conv[0] on the current token; the window
    # is ordered oldest->newest, so the taps are flipped to match
    conv_w = torch.flip(params["conv"], dims=(0,)).to(x.dtype)
    xc = silu(torch.einsum("bkd,kd->bd", window, conv_w))[:, None, :]
    a_bar, bx, c, _ = _selective_terms(params, xc, cfg)          # [B,1,di,n]
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
