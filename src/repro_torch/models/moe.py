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


def _route(xt: torch.Tensor, router: torch.Tensor, cfg: LMConfig, C: int):
    """Router, top-k and capacity slots of xt [G,Tl,D]: (probs [G,Tl,E],
    gate_vals and expert_idx [G,Tl,K], eid and slot [G,Tl*K] (slot C = the
    trash row), keep [G,Tl*K])."""
    G, Tl, _ = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", xt.float(), router)
    probs = torch.softmax(logits, dim=-1)                        # [G,Tl,E]
    gate_vals, expert_idx = top_k(probs, K)                      # [G,Tl,K]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    # slot assignment per group: position within each expert's local queue
    sel = torch.nn.functional.one_hot(expert_idx, E)             # [G,Tl,K,E]
    flat_sel = sel.reshape(G, Tl * K, E)
    pos_in_expert = torch.cumsum(flat_sel, dim=1) - flat_sel
    slot = torch.sum(pos_in_expert * flat_sel, dim=-1)           # [G,Tl*K]
    eid = expert_idx.reshape(G, Tl * K)
    keep = slot < C
    slot = torch.where(keep, slot, torch.full_like(slot, C))     # C = trash
    return probs, gate_vals, expert_idx, eid, slot, keep


def _scatter(xt: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor,
             E: int, C: int, K: int) -> torch.Tensor:
    """Tokens into [G, E, C, D] buckets.  They go through [G, E, C+1, D]:
    only the trash row C takes more than one token, and it is never
    read."""
    G, Tl, D = xt.shape
    dev = xt.device
    tok_ids = torch.arange(Tl, device=dev).repeat_interleave(K)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Tl * K)
    buckets = torch.zeros((G, E, C + 1, D), dtype=xt.dtype, device=dev)
    buckets[gidx, eid, slot] = xt[:, tok_ids]
    return buckets[:, :, :C, :]


def expert_mlp(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its buckets: h [G,E,C,D] -> [G,E,C,D]."""
    gate = torch.einsum("gecd,edf->gecf", h, w_gate)
    up = torch.einsum("gecd,edf->gecf", h, w_up)
    return torch.einsum("gecf,efd->gecd", silu(gate) * up, w_down)


def combine(y: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor,
            w: torch.Tensor, Tl: int, local: bool = False) -> torch.Tensor:
    """Expert outputs y [G,E,C,D] gathered back to their tokens, weighted
    by w [G,Tl*K] and summed per token (`index_add_`) -> [G,Tl,D].
    `local`: y holds a slice of the experts, `eid` counts from its first,
    and pairs outside it add nothing."""
    G, E, C, D = y.shape
    K = eid.shape[1] // Tl
    dt, dev = y.dtype, y.device
    if local:
        inside = (eid >= 0) & (eid < E)
        eid = torch.where(inside, eid, 0)
        slot = torch.where(inside, slot, C)
    tok_ids = torch.arange(Tl, device=dev).repeat_interleave(K)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Tl * K)
    y_pad = torch.cat([y, torch.zeros((G, E, 1, D), dtype=dt, device=dev)],
                      dim=2)
    y_tok = y_pad[gidx, eid, slot]                               # [G,Tl*K,D]
    out = torch.zeros((G, Tl, D), dtype=dt, device=dev)
    for g in range(G):
        out[g].index_add_(0, tok_ids, y_tok[g] * w[g][:, None])
    return out


def dispatch(xt: torch.Tensor, router: torch.Tensor, cfg: LMConfig, C: int):
    """The dispatch of a mesh's local groups (`sharding.parallel`):
    (buckets [G,E,C,D], eid, slot, combine weights w [G,Tl*K], the
    per-group sums of the router probs and of the top-1 one-hot [G,E] for
    the aux loss, the dropped count per group [G])."""
    E, K = cfg.n_experts, cfg.top_k
    G, Tl, _ = xt.shape
    probs, gate_vals, expert_idx, eid, slot, keep = _route(xt, router, cfg, C)
    me_sum = torch.sum(probs, dim=1)
    ce_sum = torch.sum(torch.nn.functional.one_hot(expert_idx[..., 0], E)
                       .float(), dim=1)
    h = _scatter(xt, eid, slot, E, C, K)
    w = (gate_vals.reshape(G, Tl * K) * keep).to(xt.dtype)
    return h, eid, slot, w, me_sum, ce_sum, torch.sum(~keep, dim=1)


def moe_block(params, x: torch.Tensor, cfg: LMConfig,
              dispatch_groups: int = 1, constrain=None, mesh=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,D] -> (out [B,S,D], {"aux_loss": scalar, "dropped": the
    number of (token, expert) assignments beyond capacity}).

    Dispatch is group-local: tokens split into `dispatch_groups`, each group
    scattering into its own capacity buckets [G, E, C, D].  On a mesh
    (`constrain`, `mesh` from `LM.use_mesh`) the groups and the experts are
    sharded (`sharding.parallel.moe_block`)."""
    if mesh is not None:
        from repro_torch.sharding import parallel
        return parallel.moe_block(params, x, cfg, dispatch_groups,
                                  constrain, mesh)
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    G = dispatch_groups if T % dispatch_groups == 0 else 1
    Tl = T // G
    C = _capacity(cfg, Tl)
    xt = x.reshape(G, Tl, D)

    probs, gate_vals, expert_idx, eid, slot, keep = _route(
        xt, params["router"], cfg, C)
    # load-balance aux loss (Switch-style, global means)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.nn.functional.one_hot(expert_idx[..., 0], E)
                    .float(), dim=(0, 1))
    aux = const(cfg.router_aux_coef * E, me) * torch.sum(me * ce)

    h = _scatter(xt, eid, slot, E, C, K)
    dt = x.dtype
    y = expert_mlp(h, params["w_gate"].to(dt), params["w_up"].to(dt),
                   params["w_down"].to(dt))                      # [G,E,C,D]
    # gather back with router weights
    w = (gate_vals.reshape(G, Tl * K) * keep).to(dt)
    out = combine(y, eid, slot, w, Tl)
    dropped = torch.sum(~keep)
    return out.reshape(B, S, D), {"aux_loss": aux, "dropped": dropped}
