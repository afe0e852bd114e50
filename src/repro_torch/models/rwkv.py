"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix
(the reference's `repro.models.rwkv`).

The WKV recurrence keeps a per-head [hd, hd] state, O(1) in sequence
length.  Training/prefill loops over time (the reference's `lax.scan`);
decode is the same loop over one step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ParamSpec, const, silu
from repro_torch.models.lm_config import LMConfig
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.sharding.dtensor import split_last


def _heads(cfg: LMConfig) -> Tuple[int, int]:
    hd = cfg.head_dim
    return cfg.d_model // hd, hd


def rwkv_specs(cfg: LMConfig) -> Dict[str, Dict[str, ParamSpec]]:
    d = cfg.d_model
    ff = cfg.d_ff
    pd = cfg.pdtype
    f32 = torch.float32
    lora = max(32, d // 16)
    return {
        "time": {
            # token-shift lerp coefficients for r/k/v/w/g
            "mu": ParamSpec((5, d), (None, "embed"), init="zeros", dtype=pd),
            "w_r": ParamSpec((d, d), ("embed", "heads_qkv"), dtype=pd),
            "w_k": ParamSpec((d, d), ("embed", "heads_qkv"), dtype=pd),
            "w_v": ParamSpec((d, d), ("embed", "heads_qkv"), dtype=pd),
            "w_g": ParamSpec((d, d), ("embed", "heads_qkv"), dtype=pd),
            "w_o": ParamSpec((d, d), ("heads_qkv", "embed"), dtype=pd),
            # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
            "decay_w0": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
            "decay_a": ParamSpec((d, lora), ("embed", None), dtype=pd),
            "decay_b": ParamSpec((lora, d), (None, "embed"),
                                 init="scaled", scale=0.1, dtype=pd),
            "bonus_u": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
            "ln_x": ParamSpec((d,), ("embed",), init="ones", dtype=pd),
        },
        "channel": {
            "mu": ParamSpec((2, d), (None, "embed"), init="zeros", dtype=pd),
            "w_k": ParamSpec((d, ff), ("embed", "mlp"), dtype=pd),
            "w_v": ParamSpec((ff, d), ("mlp", "embed"), dtype=pd),
            "w_r": ParamSpec((d, d), ("embed", "heads_qkv"), dtype=pd),
        },
    }


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: previous token's features (last = carry from prefix)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_terms(tp, x: torch.Tensor, xx: torch.Tensor, cfg: LMConfig):
    """r/k/v/g/decay for a chunk.  x, xx (shifted) [B,S,D]."""
    H, hd = _heads(cfg)
    mu = tp["mu"].to(x.dtype)
    mix = lambda i: x + (xx - x) * mu[i]
    r = mix(0) @ tp["w_r"].to(x.dtype)
    k = mix(1) @ tp["w_k"].to(x.dtype)
    v = mix(2) @ tp["w_v"].to(x.dtype)
    g = silu(mix(4) @ tp["w_g"].to(x.dtype))
    xw = mix(3).float()
    decay_raw = tp["decay_w0"] + torch.tanh(
        xw @ tp["decay_a"].float()) @ tp["decay_b"].float()
    w = torch.exp(-torch.exp(decay_raw - const(3.0, decay_raw)))
    shp = x.shape[:-1] + (H, hd)
    return (split_last(r, shp), split_last(k, shp), split_last(v, shp),
            g, split_last(w, shp))


def _wkv_step(state: torch.Tensor, inputs, u: torch.Tensor):
    """state [B,H,hd,hd]; r/k/v/w [B,H,hd] for one step."""
    r, k, v, w = inputs
    kv = k[..., :, None] * v[..., None, :]                 # [B,H,hd,hd]
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[..., :, None] * kv)
    new_state = state * w[..., :, None] + kv
    return new_state, out


def wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence over time: r/k/v/w [B,S,H,hd], u [H,hd], state
    [B,H,hd,hd] -> (out [B,S,H,hd], the final state)."""
    outs = []
    for t in range(r.shape[1]):
        state, o = _wkv_step(state, (r[:, t], k[:, t], v[:, t], w[:, t]), u)
        outs.append(o)
    return torch.stack(outs, dim=1), state


def time_mix(tp, x: torch.Tensor, cfg: LMConfig, last_x: torch.Tensor,
             state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill/train over a sequence.  Returns (out, new_last_x, new_state)."""
    B, S, D = x.shape
    H, hd = _heads(cfg)
    xx = _shift(x, last_x)
    r, k, v, g, w = _time_mix_terms(tp, x, xx, cfg)
    u = split_last(tp["bonus_u"], (H, hd))
    r, k, v, w = (t.float() for t in (r, k, v, w))
    if hasattr(r, "device_mesh"):          # a DTensor (`LM.use_mesh`)
        from repro_torch.sharding import parallel
        out, state = parallel.wkv_scan(wkv_scan, r, k, v, w, u, state)
    else:
        out, state = wkv_scan(r, k, v, w, u, state)
    out = out.reshape(B, S, D).to(x.dtype)
    # group-norm per head approximated by RMS over features
    out32 = out.float()
    out = (out32 * torch.rsqrt(
        torch.mean(torch.square(out32), dim=-1, keepdim=True)
        + const(1e-5, out32))
        * tp["ln_x"].float()).to(x.dtype)
    out = out * g
    return out @ tp["w_o"].to(x.dtype), x[:, -1, :], state


def channel_mix(cp, x: torch.Tensor, last_x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    xx = _shift(x, last_x)
    mu = cp["mu"].to(x.dtype)
    xk = x + (xx - x) * mu[0]
    xr = x + (xx - x) * mu[1]
    k = torch.square(torch.relu(xk @ cp["w_k"].to(x.dtype)))
    r = torch.sigmoid(xr @ cp["w_r"].to(x.dtype))
    return r * (k @ cp["w_v"].to(x.dtype)), x[:, -1, :]


def rwkv_block(params, x: torch.Tensor, cfg: LMConfig, state: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """Full RWKV6 block over a sequence chunk with carried state.
    state = {"wkv": [B,H,hd,hd] f32, "tshift": [B,D], "cshift": [B,D]}."""
    out_t, new_tshift, new_wkv = time_mix(params["time"], x, cfg,
                                          state["tshift"], state["wkv"])
    x = x + out_t
    out_c, new_cshift = channel_mix(params["channel"], x, state["cshift"])
    x = x + out_c
    return x, {"wkv": new_wkv, "tshift": new_tshift, "cshift": new_cshift}


def init_rwkv_state(cfg: LMConfig, batch: int, n_layers: int,
                    device: DeviceLike = "cuda") -> Dict:
    dev = resolve_device(device)
    H, hd = _heads(cfg)
    return {
        "wkv": torch.zeros((n_layers, batch, H, hd, hd), dtype=torch.float32,
                           device=dev),
        "tshift": torch.zeros((n_layers, batch, cfg.d_model),
                              dtype=cfg.adtype, device=dev),
        "cshift": torch.zeros((n_layers, batch, cfg.d_model),
                              dtype=cfg.adtype, device=dev),
    }
