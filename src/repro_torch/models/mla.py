"""Multi-head latent attention (DeepSeek-V2/V3; Moonlight), without q-LoRA.

Per layer: q = x W_q split per head into a no-position part (`qk_nope`)
and a rope part (`qk_rope`); x W_kv_a gives the latent (`kv_lora_rank`,
RMS-normed) and one rope key shared by every head; the latent times
W_kv_b gives each head's no-position key and its value; the output is the
heads' values through W_o.  The softmax scale is head_dim^-0.5 (the query
and key head, 192 at Moonlight's widths).

Rope rotates the rope part as the published modeling code does: its
channels come as interleaved pairs (2i, 2i+1), which it regroups into
halves (i, i + r/2) before the rotate-half rotation; the cached rope key
stays in that regrouped order, as queries meet it in the same order.

Two paths share the weights.  `prefill` expands keys and values from the
latent and attends causally over the whole prompt (the memory-efficient
`scaled_dot_product_attention`); it writes the latent and the roped key of
every position into the cache.  `decode` is the absorbed form: W_kv_b's
key half folds into the query, the query attends over the cached latent
and rope key (`latent_dim` values a token) up to the current position, and
the value half of W_kv_b applies after.  The cache is [slots, max_len,
latent_dim] a layer, written in place.  A decode step is placed by a
`DecodeAt`: the position it writes, on the device, and how many cache
positions it reads, those past the written one masked, so that one
captured step (a CUDA graph) serves every position up to its length.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from repro_torch.models.common import ParamSpec, const, rms_norm, rope
from repro_torch.models.lm_config import MLAConfig


#: the latent's RMSNorm eps: the published kv_a_layernorm keeps
#: DeepseekV3RMSNorm's default, not the config's rms_norm_eps
KV_NORM_EPS = 1e-6
#: prefill's attention backends: CUTLASS's memory-efficient kernel on the
#: card (cuDNN's, which PyTorch would pick first for these head sizes,
#: builds a plan for every new prompt length, seconds of host time inside
#: the serving window), the plain one elsewhere
_SDPA_BACKENDS = (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH)


def mla_specs(cfg: MLAConfig) -> Dict[str, ParamSpec]:
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.pdtype
    c = cfg.kv_lora_rank
    return {
        "wq": ParamSpec((d, H * cfg.head_dim), ("embed", "heads_qkv"),
                        dtype=pd),
        "wkv_a": ParamSpec((d, cfg.latent_dim), ("embed", None), dtype=pd),
        "kv_norm": ParamSpec((c,), (None,), init="ones", dtype=pd),
        "wkv_b": ParamSpec((c, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                           (None, "heads_qkv"), dtype=pd),
        "wo": ParamSpec((H * cfg.v_head_dim, d), ("heads_qkv", "embed"),
                        dtype=pd),
    }


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x [..., S, heads, r] with its channels in interleaved pairs, roped
    at `positions` [..., S] and returned with the pairs regrouped into
    halves."""
    r = x.shape[-1]
    x = x.unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    return rope(x, positions, theta)


def _project(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MLAConfig,
             positions: torch.Tensor):
    """(q_nope [B,S,H,nope], q_pe [B,S,H,rope] roped, c_kv [B,S,c]
    normed, k_pe [B,S,rope] roped) of x [B,S,D]."""
    B, S, _ = x.shape
    dt = x.dtype
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"].to(dt)).view(B, S, cfg.n_heads, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c_kv, k_pe = (x @ p["wkv_a"].to(dt)).split([cfg.kv_lora_rank, dr],
                                               dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], KV_NORM_EPS)
    q_pe = _rope(q_pe, positions, cfg.rope_theta)
    k_pe = _rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, c_kv, k_pe


def prefill(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MLAConfig,
            positions: torch.Tensor,
            latent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention of x [B,S,D] at `positions` [B,S] with keys and
    values expanded from the latent -> [B,S,D].  Where `latent` (this
    layer's cache, [B, max_len, latent_dim]) is given, positions 0..S-1 of
    it are written."""
    B, S, _ = x.shape
    H, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    dt = x.dtype
    q_nope, q_pe, c_kv, k_pe = _project(p, x, cfg, positions)
    if latent is not None:
        latent[:, :S] = torch.cat([c_kv, k_pe], dim=-1).to(latent.dtype)
    k_nope, v = (c_kv @ p["wkv_b"].to(dt)).view(B, S, H, dn + dv).split(
        [dn, dv], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, -1)],
                  dim=-1).transpose(1, 2)
    with sdpa_kernel(list(_SDPA_BACKENDS)):
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2),
                                           is_causal=True,
                                           scale=cfg.head_dim ** -0.5)
    return o.transpose(1, 2).reshape(B, S, H * dv) @ p["wo"].to(dt)


@dataclasses.dataclass(frozen=True)
class DecodeAt:
    """Where a decode step writes and how far it reads: `pos` [1] int64 on
    the device, the position written; `length`, the cache positions read
    (at least `pos` + 1); `mask` [length] bool, True past `pos` (None where
    `length` is `pos` + 1)."""
    pos: torch.Tensor
    length: int
    mask: Optional[torch.Tensor] = None

    @classmethod
    def exact(cls, cur_index: int, device) -> "DecodeAt":
        """Position `cur_index`, reading positions 0..cur_index."""
        return cls(torch.full((1,), cur_index, dtype=torch.int64,
                              device=device), cur_index + 1)

    @classmethod
    def within(cls, pos: torch.Tensor, length: int) -> "DecodeAt":
        """The position in `pos` [1] (int64, on the device), reading
        `length` positions with those past it masked."""
        return cls(pos, length,
                   torch.arange(length, device=pos.device) > pos)


def decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
           latent: torch.Tensor, cfg: MLAConfig,
           at: Union[int, DecodeAt]) -> torch.Tensor:
    """One token x [B,1,D] at `at` (a `DecodeAt`, or the position as an
    int) through the absorbed form over this layer's cache `latent`
    [B, max_len, latent_dim] (the position written in place) -> [B,1,D].
    Scores go to float32 for the mask and the softmax, the probabilities
    back to x's dtype."""
    B = x.shape[0]
    H, dn, dv, c = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    dt = x.dtype
    if isinstance(at, int):
        at = DecodeAt.exact(at, x.device)
    q_nope, q_pe, c_kv, k_pe = _project(p, x, cfg, at.pos.expand(B, 1))
    latent.index_copy_(1, at.pos,
                       torch.cat([c_kv, k_pe], dim=-1).to(latent.dtype))
    w_uk, w_uv = p["wkv_b"].to(dt).view(c, H, dn + dv).split([dn, dv],
                                                             dim=-1)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0], w_uk)
    q_abs = torch.cat([q_lat, q_pe[:, 0]], dim=-1)          # [B,H,c+rope]
    kv = latent[:, :at.length].to(dt)                       # [B,L,c+rope]
    sc = torch.einsum("bhk,blk->bhl", q_abs, kv).float()
    if at.mask is not None:
        sc = sc.masked_fill(at.mask, float("-inf"))
    probs = torch.softmax(sc * const(cfg.head_dim ** -0.5, sc),
                          dim=-1).to(dt)
    ctx = torch.einsum("bhl,blc->bhc", probs, kv[..., :c])
    o = torch.einsum("bhc,chd->bhd", ctx, w_uv)
    return o.reshape(B, 1, H * dv) @ p["wo"].to(dt)


def init_latent_cache(cfg: MLAConfig, batch: int, s_max: int, n_layers: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero latent caches of `n_layers` layers, in the activation dtype."""
    return {"latent": torch.zeros((n_layers, batch, s_max, cfg.latent_dim),
                                  dtype=cfg.adtype, device=device)}
