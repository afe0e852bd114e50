"""The LM's pieces whose sharded form differs from the one-device code
(`LM.use_mesh`): the attention core under each TP mode, the decode cache's
write, the vocab-parallel cross-entropy and embedding, the MoE's dispatch,
experts and combine, the WKV loop and the SSM conv.  Most run the
one-device code on each rank's shards in `local_map` regions, whose
placements and gradient placements are stated here, so that DTensor picks
no layout of its own.  Every function takes DTensors on a DeviceMesh with
the rules' axis names."""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention
from repro_torch.models.common import const


def attention_core(q, k, v, mask, cfg, mode):
    """q [B,Sq,KV,G,hd], k/v [B,Sk,KV,hd] DTensors placed by
    `LM._attn_constrain`, mask [Sq,Sk] -> [B,Sq,heads*hd].

    Keys sharded over a mesh dim (`kv_seq`, and the decode's
    sequence-sharded cache) take `_seq_parallel_core`, sharded heads
    `_head_parallel_core`: local regions, so that DTensor neither gathers
    the scores for the softmax nor re-lays them out in the backward."""
    from torch.distributed.tensor import Shard
    if Shard(1) in tuple(k.placements):
        out = _seq_parallel_core(q, k, v, mask, cfg)
    else:
        out = _head_parallel_core(q, k, v, mask, cfg)
    return attention._merge_heads(out, cfg, mode == "q_groups")


def _head_parallel_core(q, k, v, mask, cfg):
    """Heads sharded (`kv_heads`: q, k, v on the KV dim; `q_groups`: q on
    its group dim, k and v whole): the one-device core on each rank's
    heads in a local region, whole key rows, no collective.  k and v
    replicated beside sharded q get partial gradients."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = q.device_mesh
    q_pl, kv_pl = tuple(q.placements), tuple(k.placements)
    kv_grad = tuple(Partial() if kp == Replicate() and qp != Replicate()
                    else kp for qp, kp in zip(q_pl, kv_pl))
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, rep, run_check=False)
    return _region(functools.partial(attention.attend, cfg=cfg), mesh,
                   (q, k, v, mask), (q_pl, kv_pl, kv_pl, rep), (q_pl,),
                   (q_pl, kv_grad, kv_grad, rep))


def _seq_parallel_core(q, k, v, mask, cfg):
    """Context parallelism (the reference's `kv_seq`): each rank holds a
    slice of the keys; scores, the softmax's max and sum, and PV run on
    it in local regions, the max and the sum reduce over the key-sharding
    mesh dim as partial placements, and PV leaves a partial sum
    [B,Sq,KV,G,hd] for the head merge to reduce.  The max only steadies
    the exponent, so it is taken without a gradient.  q is gathered over
    that mesh dim first (its gradient a partial sum there)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = k.device_mesh
    kv_pl = tuple(k.placements)
    seq = [p == Shard(1) for p in kv_pl]
    q_pl = tuple(Replicate() if s else p for s, p in zip(seq, kv_pl))
    q_grad = tuple(Partial() if s else p for s, p in zip(seq, kv_pl))
    s_pl = tuple(Shard(4) if s else p for s, p in zip(seq, kv_pl))
    r_pl = q_pl                                   # [B,KV,G,Sq] reduced
    m_pl = tuple(Shard(1) if s else Replicate() for s in seq)
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    dt = q.dtype

    def partial(op):
        return tuple(Partial(op) if s else p for s, p in zip(seq, kv_pl))

    scores = _region(functools.partial(attention.scores, cfg=cfg), mesh,
                     (q, k, mask), (q_pl, kv_pl, m_pl), (s_pl,),
                     (q_grad, kv_pl, m_pl))
    m = _region(lambda x: torch.amax(x, dim=-1), mesh, (scores.detach(),),
                (s_pl,), (partial("max"),), (s_pl,)).redistribute(mesh, r_pl)
    den = _region(lambda x, m: torch.sum(torch.exp(x - m[..., None]), dim=-1),
                  mesh, (scores, m), (s_pl, r_pl), (partial("sum"),),
                  (s_pl, r_pl)).redistribute(mesh, r_pl)

    def pv_fn(x, m, den, v):
        probs = (torch.exp(x - m[..., None]) / den[..., None]).to(dt)
        return torch.einsum("bkgqs,bskh->bqkgh", probs, v)

    return _region(pv_fn, mesh, (scores, m, den, v),
                   (s_pl, r_pl, r_pl, kv_pl), (partial("sum"),),
                   (s_pl, r_pl, q_grad, kv_pl))


def write_position(cache, new, index: int) -> None:
    """cache[:, index] = new[:, 0] in place, for a cache DTensor
    [B,Smax,...] whose sequence may be sharded over "model": the new
    entry is brought to the cache's placements (sequence aside) and the
    rank whose slice holds `index` writes it."""
    from torch.distributed.tensor import Replicate, Shard
    pl = list(cache.placements)
    seq_dims = [i for i, p in enumerate(pl) if p == Shard(1)]
    src = new.redistribute(cache.device_mesh,
                           [Replicate() if p == Shard(1) else p for p in pl])
    local, row = cache.to_local(), src.to_local()[:, 0].to(cache.dtype)
    width = local.shape[1]
    owner_slice = index // width
    mine = 0
    coord = cache.device_mesh.get_coordinate()
    for i in seq_dims:                 # one mesh dim at most, by the rules
        mine = coord[i]
    if mine == owner_slice:
        local[:, index - owner_slice * width] = row


def shard_offset(t, dim: int) -> int:
    """Where this rank's shard of DTensor `t` starts along `dim`: the
    mesh dims that shard it, in mesh order, the first major."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    linear, count = 0, 1
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            linear = linear * mesh.size(i) + coord[i]
            count *= mesh.size(i)
    return linear * (t.shape[dim] // count)


def logsumexp(logits):
    """logsumexp over the last (perhaps vocab-sharded) dim: the local max
    and the local sum of exponentials, each reduced over the mesh as a
    partial placement, in local regions, so that the logits' gradient
    keeps their placements (vocab-sharded).  Whole vocab rows take
    `torch.logsumexp` on each rank's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    pl = tuple(logits.placements)
    red = tuple(Replicate() if p == Shard(vdim) else p for p in pl)
    if red == pl:       # whole vocab rows: the one-device op, its bits
        return _region(lambda x: torch.logsumexp(x, dim=-1), mesh,
                       (logits,), (pl,), (pl,), (pl,))

    def partial(op):
        return tuple(Partial(op) if p == Shard(vdim) else p for p in pl)

    m = _region(lambda x: torch.amax(x, dim=-1), mesh, (logits.detach(),),
                (pl,), (partial("max"),), (pl,)).redistribute(mesh, red)
    s = _region(lambda x, m: torch.sum(torch.exp(x - m[..., None]), dim=-1),
                mesh, (logits, m), (pl, red), (partial("sum"),),
                (pl, red)).redistribute(mesh, red)
    return torch.log(s) + m


def label_logits(logits, labels):
    """logits[..., labels] for logits [B,S,V] whose vocab may be sharded
    over "model" (vocab-parallel cross-entropy): each rank picks the labels
    inside its vocab slice, zero elsewhere, and the picks sum over the
    mesh (a partial placement, then replicated)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    lab = labels.redistribute(mesh, [p if p != Shard(vdim) else Replicate()
                                     for p in logits.placements])
    local, lab_l = logits.to_local(), lab.to_local().long()
    v0 = shard_offset(logits, vdim)
    idx = lab_l - v0
    inside = (idx >= 0) & (idx < local.shape[-1])
    picked = torch.gather(local, -1, torch.where(inside, idx, 0)[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    out_pl = [Partial() if p == Shard(vdim) else p for p in logits.placements]
    out = DTensor.from_local(picked, mesh, out_pl, run_check=False,
                             shape=logits.shape[:-1],
                             stride=lab.stride())
    return out.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                   else p for p in out_pl])


# ------------------------------------------------------------------ MoE

def _region(fn, mesh, args, in_pl, out_pl, grad_pl=None):
    """`fn` on the local shards of `args` (DTensors redistributed to
    `in_pl`, other values passed as they are), its outputs wrapped as
    DTensors of `out_pl`; `grad_pl` names where an input's gradient is a
    partial sum (`local_map`)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def moe_block(params, x, cfg, dispatch_groups: int, constrain, mesh):
    """The MoE block on a mesh: `models.moe.moe_block`'s arithmetic with
    the groups G over the data axes and the experts E over "model" where
    E divides it (EP).

    Three local regions: the dispatch (router, top-k, capacity slots and
    the [G,E,C,D] buckets of each rank's own groups, every model rank
    alike), the experts' SwiGLU on the rank's experts (the weights'
    FSDP shards gathered first), and the combine, where each model rank
    adds its own experts' outputs into a partial sum over "model" that
    the next layer boundary reduces.  With the tokens replicated over
    "model", the trip to the experts is a local slice and the trip back a
    reduction; there is no all-to-all."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import moe as moe_mod
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    G = dispatch_groups if T % dispatch_groups == 0 else 1
    Tl = T // G
    C = moe_mod._capacity(cfg, Tl)
    names = tuple(mesh.mesh_dim_names)
    xt = constrain(x.view(G, Tl, D), ("act_batch", None, None))
    dp = [p for p in xt.placements]                 # G over the data axes
    m = names.index("model") if "model" in names else None
    ep = m is not None and E % mesh.size(m) == 0

    def per_dim(data, model):
        return tuple(model if i == m else data[i] for i in range(len(names)))

    rep = per_dim([Replicate()] * len(names), Replicate())
    g_pl = per_dim(dp, Replicate())
    g_partial = per_dim([Partial() if p == Shard(0) else p for p in dp],
                        Replicate())

    def dispatch(xt, router):
        return moe_mod.dispatch(xt, router, cfg, C)

    h, eid, slot, w, me_sum, ce_sum, dropped = _region(
        dispatch, mesh, (xt, params["router"]), (g_pl, rep),
        (g_pl,) * 7, (g_pl, g_partial))
    me = torch.sum(me_sum, dim=0) / const(G * Tl, me_sum)
    ce = torch.sum(ce_sum, dim=0) / const(G * Tl, ce_sum)
    aux = const(cfg.router_aux_coef * E, me) * torch.sum(me * ce)

    e_pl = per_dim(dp, Shard(1) if ep else Replicate())
    w_pl = per_dim([Replicate()] * len(names), Shard(0) if ep else Replicate())
    w_grad = per_dim([Partial() if p == Shard(0) else Replicate()
                      for p in dp], Shard(0) if ep else Replicate())
    h = constrain(h, ("act_batch", "experts", None, "act_embed"))
    dt = x.dtype

    def experts(h, wg, wu, wd):
        return moe_mod.expert_mlp(h, wg.to(dt), wu.to(dt), wd.to(dt))

    y = _region(experts, mesh, (h, params["w_gate"], params["w_up"],
                                params["w_down"]),
                (e_pl, w_pl, w_pl, w_pl), (e_pl,),
                (e_pl, w_grad, w_grad, w_grad))
    y = constrain(y, ("act_batch", "experts", None, "act_embed"))
    e0 = shard_offset(y, 1)
    out_pl = per_dim(dp, Partial() if ep else Replicate())
    w_in_grad = per_dim(dp, Partial() if ep else Replicate())

    # whole sequences per group: the local [G,Tl,D] is the rows' [B,S,D]
    rows = B % G == 0

    def combine(y, eid, slot, w):
        out = moe_mod.combine(y, eid - e0, slot, w, Tl, local=ep)
        return out.reshape(-1, S, D) if rows else out

    out = _region(combine, mesh, (y, eid, slot, w),
                  (e_pl, g_pl, g_pl, g_pl), (out_pl,),
                  (e_pl, g_pl, g_pl, w_in_grad))
    if not rows:
        out = out.redistribute(mesh, per_dim(dp, Replicate())).view(B, S, D)
    return out, {"aux_loss": aux, "dropped": torch.sum(dropped)}


# ------------------------------------------------------------------ RWKV

def wkv_scan(scan, r, k, v, w, u, state):
    """`models.rwkv.wkv_scan` on each rank's shard (batch over the data
    axes, heads over "model" where they divide): a time loop of local ops,
    no collective.  u, an FSDP-sharded parameter, is gathered first; its
    gradient is a partial sum over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = r.device_mesh
    names = tuple(mesh.mesh_dim_names)
    r_pl = tuple(r.placements)
    s_pl = tuple(Shard(1) if p == Shard(2) else p for p in r_pl)
    u_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in r_pl)
    u_grad = tuple(Partial() if names[i] != "model" and p == Shard(0)
                   else u_pl[i] for i, p in enumerate(r_pl))
    if not hasattr(state, "device_mesh"):
        from torch.distributed.tensor import DTensor
        state = DTensor.from_local(state, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    return _region(scan, mesh, (r, k, v, w, u, state),
                   (r_pl,) * 4 + (u_pl, s_pl), (r_pl, s_pl),
                   (r_pl,) * 4 + (u_grad, s_pl))


# ------------------------------------------------------------------ embed

def embed(table, tokens):
    """table[tokens] for a table [V,D] whose vocab may be sharded over
    "model" (its FSDP shards gathered): each rank looks up the tokens
    inside its vocab slice, zero elsewhere, and the rows sum over "model"
    (a partial placement).  The table's gradient is the rank's slice,
    partial over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    t_pl = tuple(table.placements)
    sharded = Shard(0) in t_pl
    v0 = shard_offset(table, 0)
    tok_pl = tuple(p if p == Shard(0) else Replicate()
                   for p in tokens.placements)
    out_pl = tuple(Partial() if tp == Shard(0) else q
                   for tp, q in zip(t_pl, tok_pl))
    grad_pl = tuple(tp if tp == Shard(0) else
                    (Partial() if q == Shard(0) else Replicate())
                    for tp, q in zip(t_pl, tok_pl))

    def lookup(tab, tok):
        tok = tok.long()
        if not sharded:
            return torch.nn.functional.embedding(tok, tab)
        idx = tok - v0
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = torch.nn.functional.embedding(torch.where(inside, idx, 0), tab)
        return rows * inside[..., None].to(rows.dtype)

    return _region(lookup, mesh, (table, tokens), (t_pl, tok_pl), (out_pl,),
                   (grad_pl, tok_pl))


# ------------------------------------------------------------------ SSM

def conv_scan(conv, x, w):
    """`models.ssm._conv_scan` (`conv`) on each rank's shard: x [B,S,di]
    with its batch and inner dims sharded, the taps w [K,di] sharded
    alike on di.  The conv runs along the unsharded sequence, so nothing
    moves; the taps' gradient is a partial sum where x's batch is
    sharded."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    x_pl = tuple(x.placements)
    w_pl = tuple(Shard(1) if p == Shard(2) else Replicate() for p in x_pl)
    w_grad = tuple(Shard(1) if p == Shard(2) else
                   (Partial() if isinstance(p, Shard) else Replicate())
                   for p in x_pl)
    return _region(conv, mesh, (x, w), (x_pl, w_pl), (x_pl,),
                   (x_pl, w_grad))
