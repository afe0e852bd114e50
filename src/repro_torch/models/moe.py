"""Token-choice top-k MoE with capacity-based scatter dispatch (the
reference's `repro.models.moe`).

Slot positions come from a per-expert cumulative count, tokens scatter into
[G, E, C, D] buckets, experts run as one batched SwiGLU over the expert
dimension, and outputs gather back with router weights.  Tokens beyond
capacity are dropped exactly as in the reference, and the router adds a
load-balance auxiliary loss.

Two orders are made explicit here.  The top-k takes the experts by a stable
descending sort, so ties go to the lower expert index as `jax.lax.top_k`
breaks them (`torch.topk` promises no order).  The combine sums each
token's expert outputs with `index_add_`: on the CPU in (token, k) order,
on the card by atomics in no fixed order, so with top_k > 2 a card run can
differ from the CPU in the last bits of a sum of top_k terms (float32: a
few ulp of the output, within the LM checks' rtol 1e-4).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ParamSpec, const, silu
from repro_torch.models.lm_config import LMConfig


def moe_specs(cfg: LMConfig) -> Dict[str, ParamSpec]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    pd = cfg.pdtype
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype=torch.float32),
        "w_gate": ParamSpec((e, d, ff), ("experts", "embed", "mlp"), dtype=pd),
        "w_up": ParamSpec((e, d, ff), ("experts", "embed", "mlp"), dtype=pd),
        "w_down": ParamSpec((e, ff, d), ("experts", "mlp", "embed"), dtype=pd),
    }


def _capacity(cfg: LMConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-c // 8) * 8)    # pad to 8, as the reference does


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: values descending, ties to the
    lower index (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(params, x: torch.Tensor, cfg: LMConfig,
              dispatch_groups: int = 1
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,D] -> (out [B,S,D], {"aux_loss": scalar, "dropped": the
    number of (token, expert) assignments beyond capacity}).

    Dispatch is group-local: tokens split into `dispatch_groups`, each group
    scattering into its own capacity buckets [G, E, C, D]."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    G = dispatch_groups if T % dispatch_groups == 0 else 1
    Tl = T // G
    C = _capacity(cfg, Tl)
    xt = x.reshape(G, Tl, D)
    dev = x.device

    logits = torch.einsum("gtd,de->gte", xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                        # [G,Tl,E]
    gate_vals, expert_idx = top_k(probs, K)                      # [G,Tl,K]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style, global means)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.nn.functional.one_hot(expert_idx[..., 0], E)
                    .float(), dim=(0, 1))
    aux = const(cfg.router_aux_coef * E, me) * torch.sum(me * ce)

    # slot assignment per group: position within each expert's local queue
    sel = torch.nn.functional.one_hot(expert_idx, E)             # [G,Tl,K,E]
    flat_sel = sel.reshape(G, Tl * K, E)
    pos_in_expert = torch.cumsum(flat_sel, dim=1) - flat_sel
    slot = torch.sum(pos_in_expert * flat_sel, dim=-1)           # [G,Tl*K]
    eid = expert_idx.reshape(G, Tl * K)
    keep = slot < C
    slot = torch.where(keep, slot, torch.full_like(slot, C))     # C = trash

    # scatter tokens into [G, E, C+1, D] buckets; only the trash row C
    # takes more than one token, and it is never read
    tok_ids = torch.arange(Tl, device=dev).repeat_interleave(K)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Tl * K)
    buckets = torch.zeros((G, E, C + 1, D), dtype=x.dtype, device=dev)
    buckets[gidx, eid, slot] = xt[:, tok_ids]

    h = buckets[:, :, :C, :]
    dt = x.dtype
    gate = torch.einsum("gecd,edf->gecf", h, params["w_gate"].to(dt))
    up = torch.einsum("gecd,edf->gecf", h, params["w_up"].to(dt))
    y = torch.einsum("gecf,efd->gecd", silu(gate) * up,
                     params["w_down"].to(dt))                    # [G,E,C,D]

    # gather back with router weights
    y_pad = torch.cat([y, torch.zeros((G, E, 1, D), dtype=dt, device=dev)],
                      dim=2)
    y_tok = y_pad[gidx, eid, slot]                               # [G,Tl*K,D]
    w = (gate_vals.reshape(G, Tl * K) * keep).to(dt)
    out = torch.zeros((G, Tl, D), dtype=dt, device=dev)
    for g in range(G):
        out[g].index_add_(0, tok_ids, y_tok[g] * w[g][:, None])
    dropped = torch.sum(~keep)
    return out.reshape(B, S, D), {"aux_loss": aux, "dropped": dropped}
