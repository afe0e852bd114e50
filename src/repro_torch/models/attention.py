"""GQA attention with sliding-window / softcap / qk-norm variants (the
reference's `repro.models.attention`).

Grouped layout throughout: q is [B, S, KV, G, hd] (G = q heads per kv head),
so GQA never materializes repeated KV.  Scores come out of the einsum in the
activation dtype times the scale, then softcap, mask and softmax in float32,
and the probabilities go back to the activation dtype, as in the reference.
The decode writes the new key and value into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import (ParamSpec, checkpoint_name, const,
                                       rms_norm, rope, scalar, softcap)
from repro_torch.models.lm_config import LMConfig
from repro_torch.runtime import DeviceLike, resolve_device

NEG_INF = -1e30


def attn_specs(cfg: LMConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.head_dim
    pd = cfg.pdtype
    specs = {
        "wq": ParamSpec((d, cfg.n_heads * hd), ("embed", "heads_qkv"), dtype=pd),
        "wk": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv_qkv"), dtype=pd),
        "wv": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv_qkv"), dtype=pd),
        "wo": ParamSpec((cfg.n_heads * hd, d), ("heads_qkv", "embed"), dtype=pd),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="ones", dtype=pd)
        specs["k_norm"] = ParamSpec((hd,), (None,), init="ones", dtype=pd)
    return specs


def _qkv(params, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    kv, g, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    with checkpoint_name("attn_q"):
        q = (x @ params["wq"].to(x.dtype)).reshape(B, S, kv, g, hd)
    with checkpoint_name("attn_k"):
        k = (x @ params["wk"].to(x.dtype)).reshape(B, S, kv, hd)
    with checkpoint_name("attn_v"):
        v = (x @ params["wv"].to(x.dtype)).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos == "rope":
        qf = rope(q.reshape(B, S, kv * g, hd), positions, cfg.rope_theta)
        q = qf.reshape(B, S, kv, g, hd)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """[Sq, Sk] additive mask: causal + optional sliding window."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        causal = causal & (q_pos[:, None] - k_pos[None, :] < window)
    return _additive(causal)


def _additive(valid: torch.Tensor) -> torch.Tensor:
    """0 where valid, -1e30 elsewhere, float32."""
    f32, dev = torch.float32, valid.device
    return torch.where(valid, scalar(0.0, f32, dev), scalar(NEG_INF, f32, dev))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """q [B,Sq,KV,G,hd], k/v [B,Sk,KV,hd], mask [Sq,Sk] -> [B,Sq,KV*G*hd]."""
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * const(scale, q)
    scores = softcap(scores.float(), cfg.attn_logit_softcap)
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    B, Sq = out.shape[0], out.shape[1]
    return out.reshape(B, Sq, cfg.n_heads * cfg.head_dim)


def attention(params, x: torch.Tensor, cfg: LMConfig, *, is_global: bool,
              positions: torch.Tensor) -> torch.Tensor:
    """Training/prefill attention; a local layer (`is_global` False under a
    windowed pattern) sees the sliding-window mask."""
    q, k, v = _qkv(params, x, cfg, positions)
    pos = positions[0] if positions.ndim > 1 else positions
    if cfg.attn_pattern != "global" and not is_global:
        mask = _mask(pos, pos, cfg.window)
    else:
        mask = _mask(pos, pos, None)
    out = _sdpa(q, k, v, mask, cfg)
    return out @ params["wo"].to(x.dtype)


def attention_decode(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     cfg: LMConfig, *, is_global: bool, cur_index: int
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode with a KV cache.

    x [B,1,D]; cache {"k": [B,Smax,KV,hd], "v": ...}; cur_index = the
    position being written (written in place).  Returns (out [B,1,D], the
    cache)."""
    B = x.shape[0]
    s_max = cache["k"].shape[1]
    positions = torch.full((B, 1), cur_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, cur_index] = k[:, 0].to(ck.dtype)
    cv[:, cur_index] = v[:, 0].to(cv.dtype)
    k_pos = torch.arange(s_max, device=x.device)
    valid = k_pos <= cur_index
    if cfg.attn_pattern != "global" and not is_global:
        valid = valid & (k_pos > cur_index - cfg.window)
    mask = _additive(valid)[None, :]
    out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), mask, cfg)
    return out @ params["wo"].to(x.dtype), {"k": ck, "v": cv}


def init_kv_cache(cfg: LMConfig, batch: int, s_max: int, n_layers: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
