"""Decoder-only LM composition: all 10 registered architectures as one module
(the reference's `repro.models.transformer`).

Params are a nested dict of tensors with the reference's keys: each
homogeneous segment of layers (kimi's dense prefix, then its MoE layers)
holds its layers' params stacked on a leading axis, and the forward and the
decode loop over that axis.  IRC mode (the paper's technique)
ternary-quantizes every projection matmul through the STE
(`core.ternary.ternary_quantize`); embeddings, router and norms stay
digital.  Training checkpoints each layer under the reference's remat
modes (`apply(remat=...)`) with `torch.utils.checkpoint`.  The decode
step updates the cache's tensors in place and returns the cache with its
index advanced.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ternary import ternary_quantize
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (REMAT_MODES, ParamSpec, abstract,
                                       const, cross_entropy_loss,
                                       logical_axes_tree, materialize,
                                       remat_context, rms_norm,
                                       sinusoidal_positions, softcap,
                                       tree_map)
from repro_torch.models.lm_config import LMConfig
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.sharding import dtensor as dist_mod

PyTree = Any

# the residual stream's axes: batch-DP, replicated over "model"; a block's
# row-parallel output is reduced to it before the residual add
_RESIDUAL = ("act_batch", "act_seq", "act_embed")

# parameter names that are crossbar-mappable projections (IRC mode)
_IRC_PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                   "w_in", "w_out", "w_dt", "w_bc", "w_r", "w_k", "w_v",
                   "w_g", "w_o")


def _stack(specs: PyTree, n: int) -> PyTree:
    """Add a leading stacked-layer dimension to every ParamSpec."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            init=s.init, scale=s.scale, dtype=s.dtype),
        specs)


def _norm_spec(cfg: LMConfig) -> ParamSpec:
    init = "zeros" if cfg.norm_plus_one else "ones"
    return ParamSpec((cfg.d_model,), ("embed",), init=init, dtype=cfg.pdtype)


def _layer(tree: PyTree, l: int) -> PyTree:
    """Layer `l` of a stacked tree (views)."""
    return tree_map(lambda a: a[l], tree)


def _write_layer(stacked: PyTree, l: int, new: PyTree, old: PyTree) -> None:
    """Copy layer `l`'s new state into the stacked cache; a tensor the
    layer wrote in place comes back as the very view `old` gave it, and is
    left as it is."""
    if isinstance(stacked, dict):
        for k in stacked:
            _write_layer(stacked[k], l, new[k], old[k])
        return
    if new is not old:
        stacked[l].copy_(new)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str        # "dense" | "moe" | "hybrid" | "rwkv"
    count: int
    layer_offset: int


class LM:
    """Functional LM: `init`, `apply` (logits), `loss`, `decode_step`."""

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        self.segments = self._plan_segments()
        # distribution state (None on one device): set by use_mesh()
        self.mesh = None
        self.act_overrides = None
        self.attn_mode = None
        self.moe_groups = 1

    def use_mesh(self, mesh, act_overrides=None) -> "LM":
        """Shard the forward over `mesh` (a DeviceMesh with the reference's
        axis names; a stand-in with `axis_names` and `devices.shape` sets
        the modes only): params and inputs are then DTensors placed by
        `repro_torch.sharding.rules`, and the residual stream is pinned to
        batch-DP at every layer boundary, as the reference pins it (without
        that, the FSDP sharding of the params' contracting dim leaks into
        the activations: tokens replicated, features sharded).
        `act_overrides` remaps logical axes (e.g. sequence parallelism).

        Attention TP mode (head counts don't always divide the model axis;
        the reference picks a valid scheme per arch):
          kv_heads : shard the KV-head dim of q/k/v
          q_groups : shard q's per-kv group dim, KV replicated; heads merge
                     group-major (`g_major`), as the reference merges them
          kv_seq   : context parallelism — shard the K/V sequence; softmax
                     and the PV contraction reduce over the model axis
        MoE dispatch groups = the DP shard count (group-local capacity)."""
        from repro_torch.sharding.rules import mesh_axis_sizes
        self.mesh = mesh
        self.act_overrides = act_overrides
        sizes = mesh_axis_sizes(mesh)
        if hasattr(mesh, "mesh_dim_names") and "pod" in sizes:
            # DTensors compute on the (pod*data, model) view
            self.mesh = dist_mod.compute_mesh(mesh)
            self.act_overrides = {**dist_mod.FLAT_OVERRIDES,
                                  **(act_overrides or {})}
        m = sizes.get("model", 1)
        self.moe_groups = sizes.get("pod", 1) * sizes.get("data", 1)
        cfg = self.cfg
        if m == 1 or cfg.block == "rwkv":
            self.attn_mode = None
        elif cfg.n_kv_heads % m == 0:
            self.attn_mode = "kv_heads"
        elif cfg.q_per_kv % m == 0:
            self.attn_mode = "q_groups"
        else:
            self.attn_mode = "kv_seq"
        return self

    @property
    def sharded(self) -> bool:
        """Whether the forward runs on DTensors (a DeviceMesh is set)."""
        return self.mesh is not None and hasattr(self.mesh, "mesh_dim_names")

    def _constrain(self, x: torch.Tensor, axes: Tuple) -> torch.Tensor:
        """Redistribute a DTensor to the rules' placements for `axes` (the
        reference's `with_sharding_constraint`); anything else as it is."""
        if not self.sharded or not dist_mod.is_dtensor(x):
            return x
        return dist_mod.constrain(x, axes, self.mesh, self.act_overrides)

    def _attn_constrain(self, q, k, v):
        """Pin the attention TP scheme chosen in use_mesh (`_attn_axes`).
        q [B,S,KV,G,hd]; k/v [B,S,KV,hd]."""
        if self.attn_mode is None:
            return q, k, v
        c = self._constrain
        return (c(q, self._attn_axes("q")), c(k, self._attn_axes("k")),
                c(v, self._attn_axes("v")))

    def _attn_axes(self, name: str) -> Tuple:
        """Logical axes q ("q") or k and v take under the TP mode:
        kv_heads shards the KV-head dim of all three, q_groups q's group
        dim (k, v whole), kv_seq the k/v sequence (context parallelism);
        batch over the DP axes throughout."""
        mode = self.attn_mode
        if name == "q":
            head = {"kv_heads": 2, "q_groups": 3}.get(mode)
            axes = ["act_batch", None, None, None, None]
        else:
            head = 2 if mode == "kv_heads" else None
            axes = ["act_batch", None, None, None]
            if mode == "kv_seq":
                axes[1] = "act_seq_model"
        if head is not None:
            axes[head] = "act_heads"
        return tuple(axes)

    def _split_heads(self, t, shape: Tuple[int, ...], name: str):
        """The projection `t` [B,S,heads*hd] viewed as `shape` with its
        heads split, on a mesh: first redistributed so that the view keeps
        its shards (batch and sequence as the target has them, the flat
        feature dim sharded only where the target shards its outermost
        head dim), then the view, then `_attn_constrain`'s placements (a
        local slice where a head dim inside the outermost is sharded)."""
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.sharding.rules import placements, spec_for_axes
        target = placements(spec_for_axes(
            self._attn_axes(name), shape, self.mesh, self.act_overrides),
            self.mesh)
        pre = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
               for p in target]
        t = t.redistribute(self.mesh, pre).view(shape)
        return t.redistribute(self.mesh, target)

    def _attn_kw(self) -> Dict[str, Any]:
        """The attention's mesh hooks (none on one device)."""
        if not self.sharded:
            return {"mode": self.attn_mode}
        return {"mode": self.attn_mode, "constrain": self._attn_constrain,
                "out_constrain": self._constrain, "mesh": self.mesh,
                "split": self._split_heads}

    def _moe_kw(self) -> Dict[str, Any]:
        """The MoE's mesh hooks (none on one device)."""
        if not self.sharded:
            return {}
        return {"constrain": self._constrain, "mesh": self.mesh}

    def _ssm_kw(self) -> Dict[str, Any]:
        """The SSM branch's mesh hook (none on one device)."""
        return {"constrain": self._constrain} if self.sharded else {}

    # ------------------------------------------------------------ structure
    def _plan_segments(self) -> List[Segment]:
        cfg = self.cfg
        if cfg.block == "rwkv":
            return [Segment("rwkv", cfg.n_layers, 0)]
        if cfg.block == "hybrid":
            return [Segment("hybrid", cfg.n_layers, 0)]
        if cfg.moe:
            segs = []
            if cfg.n_dense_prefix:
                segs.append(Segment("dense", cfg.n_dense_prefix, 0))
            segs.append(Segment("moe", cfg.n_layers - cfg.n_dense_prefix,
                                cfg.n_dense_prefix))
            return segs
        return [Segment("dense", cfg.n_layers, 0)]

    def _layer_specs(self, kind: str) -> Dict[str, PyTree]:
        cfg = self.cfg
        if kind == "rwkv":
            s = rwkv_mod.rwkv_specs(cfg)
            s["ln1"] = _norm_spec(cfg)
            s["ln2"] = _norm_spec(cfg)
            return s
        specs: Dict[str, PyTree] = {
            "ln1": _norm_spec(cfg),
            "ln2": _norm_spec(cfg),
            "attn": attn_mod.attn_specs(cfg),
        }
        if cfg.post_norm:
            specs["ln1_post"] = _norm_spec(cfg)
            specs["ln2_post"] = _norm_spec(cfg)
        if kind == "moe":
            specs["moe"] = moe_mod.moe_specs(cfg)
        elif kind == "hybrid":
            specs["ssm"] = ssm_mod.ssm_specs(cfg)
            specs["mlp"] = mlp_mod.mlp_specs(cfg)
        else:
            # kimi-style dense prefix uses top_k*d_ff as its dense hidden
            ff = cfg.d_ff * cfg.top_k if cfg.moe else cfg.d_ff
            specs["mlp"] = mlp_mod.mlp_specs(cfg, d_ff=ff)
        return specs

    def specs(self) -> Dict[str, PyTree]:
        cfg = self.cfg
        top: Dict[str, PyTree] = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), dtype=cfg.pdtype),
            "final_norm": _norm_spec(cfg),
        }
        if not cfg.tie_embeddings:
            top["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                       ("embed", "vocab"), dtype=cfg.pdtype)
        for i, seg in enumerate(self.segments):
            top[f"seg{i}_{seg.kind}"] = _stack(self._layer_specs(seg.kind),
                                               seg.count)
        return top

    def init(self, key: torch.Tensor, device: DeviceLike = "cuda") -> PyTree:
        """The reference's `init(key)`, bit for bit (`materialize`): the
        threefry kernel draws every normal leaf on the card."""
        return materialize(key, self.specs(), device)

    def abstract_params(self) -> PyTree:
        return abstract(self.specs())

    def logical_axes(self) -> PyTree:
        return logical_axes_tree(self.specs())

    # ------------------------------------------------------------ IRC mode
    def _maybe_irc(self, params: PyTree) -> PyTree:
        if not self.cfg.irc.enabled:
            return params

        def walk(tree, name=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            return ternary_quantize(tree) if name in _IRC_PROJ_NAMES else tree
        return walk(params)

    # ------------------------------------------------------------ blocks
    def _gathered(self, tree: PyTree) -> PyTree:
        """On a mesh, `tree`'s params with their FSDP shards gathered
        (`dist_mod.gather_fsdp`); as it is otherwise."""
        return dist_mod.gather_fsdp(tree) if self.sharded else tree

    def _embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.sharded:
            from repro_torch.sharding import parallel
            x = parallel.embed(self._gathered(params["embed"]), tokens)
            x = x.to(cfg.adtype)
        else:
            x = params["embed"][tokens.long()].to(cfg.adtype)
        if cfg.embed_scale:
            x = x * torch.sqrt(const(cfg.d_model, x))
        return x

    def _logits(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        params = {k: self._gathered(params[k]) for k in
                  ("final_norm", "embed", "unembed") if k in params}
        x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T.to(x.dtype)
        else:
            logits = x @ params["unembed"].to(x.dtype)
        return softcap(logits.float(), cfg.final_logit_softcap)

    def _norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, g, self.cfg.norm_eps, self.cfg.norm_plus_one)

    def _sharded_layer_fwd(self, *args):
        with dist_mod.sharded_context(True):
            return self._layer_fwd(*args)

    def _layer_fwd(self, kind: str, lp: PyTree, x: torch.Tensor,
                   is_global: bool, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer forward (train/prefill). Returns (x, aux_loss)."""
        cfg = self.cfg
        lp = self._gathered(lp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind == "rwkv":
            B = x.shape[0]
            H, hd = rwkv_mod._heads(cfg)
            wkv = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                              device=x.device)
            shift = torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                device=x.device)
            h, _, _ = rwkv_mod.time_mix(lp["time"], self._norm(x, lp["ln1"]),
                                        cfg, shift, wkv)
            x = x + self._constrain(h, _RESIDUAL)
            h, _ = rwkv_mod.channel_mix(lp["channel"],
                                        self._norm(x, lp["ln2"]), shift)
            return x + self._constrain(h, _RESIDUAL), aux

        h = self._norm(x, lp["ln1"])
        a = attn_mod.attention(lp["attn"], h, cfg, is_global=is_global,
                               positions=positions, **self._attn_kw())
        if kind == "hybrid":
            s = ssm_mod.ssm_branch(lp["ssm"], h, cfg, **self._ssm_kw())
            a = const(0.5, a) * (a + s)   # hymba: parallel attn+SSM fusion
        if cfg.post_norm:
            a = self._norm(a, lp["ln1_post"])
        x = x + self._constrain(a, _RESIDUAL)
        h = self._norm(x, lp["ln2"])
        if kind == "moe":
            m, moe_aux = moe_mod.moe_block(lp["moe"], h, cfg,
                                           dispatch_groups=self.moe_groups,
                                           **self._moe_kw())
            aux = aux + moe_aux["aux_loss"]
        else:
            m = mlp_mod.mlp(lp["mlp"], h, cfg)
        if cfg.post_norm:
            m = self._norm(m, lp["ln2_post"])
        return x + self._constrain(m, _RESIDUAL), aux

    # ------------------------------------------------------------ forward
    def apply(self, params: PyTree, tokens: torch.Tensor, *,
              remat: str = "block", scan_layers: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B,S] int -> (logits [B,S,V] float32, aux metrics).

        `remat` is the reference's per-layer rematerialization: "none"
        keeps every activation for the backward; "block" checkpoints each
        layer and saves nothing inside it; "dots" saves the outputs of
        matmuls without batch dimensions (the projections); "names" those
        of the tagged q/k/v/gate/up projections (`SAVED_NAMES`).  A mode
        changes memory, never values; it applies only while autograd
        records.  `scan_layers` is accepted for the reference's signature:
        the layer loop is always unrolled here."""
        del scan_layers
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{remat!r}")
        with dist_mod.sharded_context(self.sharded):
            return self._apply(params, tokens, remat)

    def _on_mesh(self, tree: PyTree) -> PyTree:
        """Inputs placed on a multi-pod mesh moved to its compute view
        (`dist_mod.to_mesh`); as they are otherwise."""
        return dist_mod.tree_to_mesh(tree, self.mesh) if self.sharded \
            else tree

    def _apply(self, params: PyTree, tokens: torch.Tensor, remat: str
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        params, tokens = self._on_mesh(params), self._on_mesh(tokens)
        params = self._maybe_irc(params)
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        if cfg.pos == "sinusoidal":
            x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        x = self._constrain(x, ("act_batch", "act_seq", "act_embed"))
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        layer_fwd = self._layer_fwd
        if remat != "none" and torch.is_grad_enabled():
            context_fn = remat_context(remat)
            kw = {} if context_fn is None else {"context_fn": context_fn}
            # the backward's recompute runs outside `apply`'s context
            fwd = self._sharded_layer_fwd if self.sharded else self._layer_fwd

            def layer_fwd(*args):
                return checkpoint(fwd, *args, use_reentrant=False, **kw)
        for i, seg in enumerate(self.segments):
            stacked = params[f"seg{i}_{seg.kind}"]
            for l in range(seg.count):
                x = self._constrain(x, ("act_batch", "act_seq", "act_embed"))
                x, a = layer_fwd(
                    seg.kind, _layer(stacked, l), x,
                    cfg.layer_is_global(seg.layer_offset + l), positions)
                aux_total = aux_total + a
        x = self._constrain(x, ("act_batch", "act_seq", "act_embed"))
        logits = self._constrain(self._logits(params, x),
                                 ("act_batch", "act_seq", "vocab"))
        return logits, {"moe_aux_loss": aux_total}

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
             remat: str = "block", scan_layers: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy with z-loss plus the MoE aux loss; `remat` and
        `scan_layers` as in `apply`."""
        logits, aux = self.apply(params, batch["tokens"], remat=remat,
                                 scan_layers=scan_layers)
        loss, metrics = cross_entropy_loss(logits,
                                           self._on_mesh(batch["labels"]),
                                           batch.get("mask"))
        loss = loss + aux["moe_aux_loss"]
        if self.sharded:
            loss = dist_mod.replicate(loss)
        metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------ decode
    def init_cache(self, batch: int, s_max: int,
                   device: DeviceLike = "cuda") -> PyTree:
        """Zero KV caches / recurrent states for `batch` slots of `s_max`
        positions; "index" (a Python int) is the next position."""
        cfg = self.cfg
        dev = resolve_device(device)
        cache: Dict[str, PyTree] = {"index": 0}
        for i, seg in enumerate(self.segments):
            name = f"seg{i}_{seg.kind}"
            if seg.kind == "rwkv":
                cache[name] = rwkv_mod.init_rwkv_state(cfg, batch, seg.count,
                                                       dev)
            elif seg.kind == "hybrid":
                cache[name] = {
                    "kv": attn_mod.init_kv_cache(cfg, batch, s_max, seg.count,
                                                 cfg.adtype, dev),
                    "ssm": ssm_mod.init_ssm_state(cfg, batch, seg.count, dev),
                }
            else:
                cache[name] = attn_mod.init_kv_cache(cfg, batch, s_max,
                                                     seg.count, cfg.adtype,
                                                     dev)
        return cache

    def decode_step(self, params: PyTree, tokens: torch.Tensor,
                    cache: PyTree) -> Tuple[torch.Tensor, PyTree]:
        """tokens [B,1] -> (logits [B,1,V] float32, the cache with its
        tensors updated in place and its index advanced)."""
        with dist_mod.sharded_context(self.sharded):
            return self._decode_step(params, tokens, cache)

    def _decode_step(self, params: PyTree, tokens: torch.Tensor,
                     cache: PyTree) -> Tuple[torch.Tensor, PyTree]:
        cfg = self.cfg
        params, tokens = self._on_mesh(params), self._on_mesh(tokens)
        cache = self._on_mesh(cache)
        params = self._maybe_irc(params)
        B = tokens.shape[0]
        idx = int(cache["index"])
        x = self._embed(params, tokens)
        if cfg.pos == "sinusoidal":
            pos = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
            x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
        x = self._constrain(x, ("act_batch", "act_seq", "act_embed"))
        new_cache: Dict[str, PyTree] = {"index": idx + 1}
        for i, seg in enumerate(self.segments):
            name = f"seg{i}_{seg.kind}"
            stacked = params[name]
            for l in range(seg.count):
                x = self._constrain(x, ("act_batch", "act_seq", "act_embed"))
                lc = _layer(cache[name], l)
                x, new_lc = self._layer_decode(
                    seg.kind, _layer(stacked, l), x,
                    cfg.layer_is_global(seg.layer_offset + l), lc, idx)
                _write_layer(cache[name], l, new_lc, lc)
            new_cache[name] = cache[name]
        x = self._constrain(x, ("act_batch", "act_seq", "act_embed"))
        return self._logits(params, x), new_cache

    def _layer_decode(self, kind: str, lp: PyTree, x: torch.Tensor,
                      is_global: bool, lc: PyTree, idx: int
                      ) -> Tuple[torch.Tensor, PyTree]:
        cfg = self.cfg
        lp = self._gathered(lp)
        if kind == "rwkv":
            h, ts, wkv = rwkv_mod.time_mix(
                lp["time"], self._norm(x, lp["ln1"]), cfg, lc["tshift"],
                lc["wkv"])
            x = x + self._constrain(h, _RESIDUAL)
            h, cs = rwkv_mod.channel_mix(
                lp["channel"], self._norm(x, lp["ln2"]), lc["cshift"])
            return (x + self._constrain(h, _RESIDUAL),
                    {"wkv": wkv, "tshift": ts, "cshift": cs})

        h = self._norm(x, lp["ln1"])
        kv_cache = lc["kv"] if kind == "hybrid" else lc
        a, new_kv = attn_mod.attention_decode(lp["attn"], h, kv_cache, cfg,
                                              is_global=is_global,
                                              cur_index=idx,
                                              **self._attn_kw())
        new_lc: PyTree = new_kv
        if kind == "hybrid":
            s, new_ssm = ssm_mod.ssm_decode(lp["ssm"], h, lc["ssm"], cfg,
                                            **self._ssm_kw())
            a = const(0.5, a) * (a + s)
            new_lc = {"kv": new_kv, "ssm": new_ssm}
        if cfg.post_norm:
            a = self._norm(a, lp["ln1_post"])
        x = x + self._constrain(a, _RESIDUAL)
        h = self._norm(x, lp["ln2"])
        if kind == "moe":
            m, _ = moe_mod.moe_block(lp["moe"], h, cfg,
                                     dispatch_groups=self.moe_groups,
                                     **self._moe_kw())
        else:
            m = mlp_mod.mlp(lp["mlp"], h, cfg)
        if cfg.post_norm:
            m = self._norm(m, lp["ln2_post"])
        return x + self._constrain(m, _RESIDUAL), new_lc
