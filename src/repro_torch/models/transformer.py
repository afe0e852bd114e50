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

PyTree = Any

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


def _write_layer(stacked: PyTree, l: int, new: PyTree) -> None:
    """Copy layer `l`'s new state into the stacked cache (a tensor the
    layer already wrote in place is left as it is)."""
    if isinstance(stacked, dict):
        for k in stacked:
            _write_layer(stacked[k], l, new[k])
        return
    dst = stacked[l]
    if new.data_ptr() != dst.data_ptr():
        dst.copy_(new)


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
        self.moe_groups = 1

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
    def _embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(cfg.adtype)
        if cfg.embed_scale:
            x = x * torch.sqrt(const(cfg.d_model, x))
        return x

    def _logits(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T.to(x.dtype)
        else:
            logits = x @ params["unembed"].to(x.dtype)
        return softcap(logits.float(), cfg.final_logit_softcap)

    def _norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, g, self.cfg.norm_eps, self.cfg.norm_plus_one)

    def _layer_fwd(self, kind: str, lp: PyTree, x: torch.Tensor,
                   is_global: bool, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer forward (train/prefill). Returns (x, aux_loss)."""
        cfg = self.cfg
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
            x = x + h
            h, _ = rwkv_mod.channel_mix(lp["channel"],
                                        self._norm(x, lp["ln2"]), shift)
            return x + h, aux

        h = self._norm(x, lp["ln1"])
        a = attn_mod.attention(lp["attn"], h, cfg, is_global=is_global,
                               positions=positions)
        if kind == "hybrid":
            s = ssm_mod.ssm_branch(lp["ssm"], h, cfg)
            a = const(0.5, a) * (a + s)   # hymba: parallel attn+SSM fusion
        if cfg.post_norm:
            a = self._norm(a, lp["ln1_post"])
        x = x + a
        h = self._norm(x, lp["ln2"])
        if kind == "moe":
            m, moe_aux = moe_mod.moe_block(lp["moe"], h, cfg,
                                           dispatch_groups=self.moe_groups)
            aux = aux + moe_aux["aux_loss"]
        else:
            m = mlp_mod.mlp(lp["mlp"], h, cfg)
        if cfg.post_norm:
            m = self._norm(m, lp["ln2_post"])
        return x + m, aux

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
        cfg = self.cfg
        params = self._maybe_irc(params)
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        if cfg.pos == "sinusoidal":
            x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        layer_fwd = self._layer_fwd
        if remat != "none" and torch.is_grad_enabled():
            context_fn = remat_context(remat)
            kw = {} if context_fn is None else {"context_fn": context_fn}

            def layer_fwd(*args):
                return checkpoint(self._layer_fwd, *args,
                                  use_reentrant=False, **kw)
        for i, seg in enumerate(self.segments):
            stacked = params[f"seg{i}_{seg.kind}"]
            for l in range(seg.count):
                x, a = layer_fwd(
                    seg.kind, _layer(stacked, l), x,
                    cfg.layer_is_global(seg.layer_offset + l), positions)
                aux_total = aux_total + a
        return self._logits(params, x), {"moe_aux_loss": aux_total}

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
             remat: str = "block", scan_layers: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy with z-loss plus the MoE aux loss; `remat` and
        `scan_layers` as in `apply`."""
        logits, aux = self.apply(params, batch["tokens"], remat=remat,
                                 scan_layers=scan_layers)
        loss, metrics = cross_entropy_loss(logits, batch["labels"],
                                           batch.get("mask"))
        loss = loss + aux["moe_aux_loss"]
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
        cfg = self.cfg
        params = self._maybe_irc(params)
        B = tokens.shape[0]
        idx = int(cache["index"])
        x = self._embed(params, tokens)
        if cfg.pos == "sinusoidal":
            pos = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
            x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
        new_cache: Dict[str, PyTree] = {"index": idx + 1}
        for i, seg in enumerate(self.segments):
            name = f"seg{i}_{seg.kind}"
            stacked = params[name]
            for l in range(seg.count):
                x, new_lc = self._layer_decode(
                    seg.kind, _layer(stacked, l), x,
                    cfg.layer_is_global(seg.layer_offset + l),
                    _layer(cache[name], l), idx)
                _write_layer(cache[name], l, new_lc)
            new_cache[name] = cache[name]
        return self._logits(params, x), new_cache

    def _layer_decode(self, kind: str, lp: PyTree, x: torch.Tensor,
                      is_global: bool, lc: PyTree, idx: int
                      ) -> Tuple[torch.Tensor, PyTree]:
        cfg = self.cfg
        if kind == "rwkv":
            h, ts, wkv = rwkv_mod.time_mix(
                lp["time"], self._norm(x, lp["ln1"]), cfg, lc["tshift"],
                lc["wkv"])
            x = x + h
            h, cs = rwkv_mod.channel_mix(
                lp["channel"], self._norm(x, lp["ln2"]), lc["cshift"])
            return x + h, {"wkv": wkv, "tshift": ts, "cshift": cs}

        h = self._norm(x, lp["ln1"])
        kv_cache = lc["kv"] if kind == "hybrid" else lc
        a, new_kv = attn_mod.attention_decode(lp["attn"], h, kv_cache, cfg,
                                              is_global=is_global,
                                              cur_index=idx)
        new_lc: PyTree = new_kv
        if kind == "hybrid":
            s, new_ssm = ssm_mod.ssm_decode(lp["ssm"], h, lc["ssm"], cfg)
            a = const(0.5, a) * (a + s)
            new_lc = {"kv": new_kv, "ssm": new_ssm}
        if cfg.post_norm:
            a = self._norm(a, lp["ln1_post"])
        x = x + a
        h = self._norm(x, lp["ln2"])
        if kind == "moe":
            m, _ = moe_mod.moe_block(lp["moe"], h, cfg,
                                     dispatch_groups=self.moe_groups)
        else:
            m = mlp_mod.mlp(lp["mlp"], h, cfg)
        if cfg.post_norm:
            m = self._norm(m, lp["ln2_post"])
        return x + m, new_lc
