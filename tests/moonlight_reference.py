"""Plain float32 reference of the MLA block (DeepSeek-V3 without q-LoRA or
YaRN; Moonlight-16B-A3B) for the CPU tests: one token sequence through the
published forward pass, with no cache, batching or kernels.  The same
mathematics as the benchmark's copy (`bench/reference/moonlight-16b-a3b.py`),
written on its own so that neither tests the other.

`weights` holds per-layer dicts of plain tensors, matrices stored [in, out]:
{"embed", "unembed", "final_norm", "layers": [{"ln1", "ln2", "wq", "wkv_a",
"kv_norm", "wkv_b", "wo", and "mlp": {...} or "router", "score_bias",
"w_gate", "w_up", "w_down", "shared": {...}}]}; `cfg` is an `MLAConfig`.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def from_program(params: Dict, cfg) -> Dict:
    """The port's parameter tree (segments of stacked layers) as per-layer
    dicts."""
    layers: List[Dict] = []
    for name in sorted(k for k in params if k.startswith("seg")):
        seg = params[name]
        for l in range(seg["ln1"].shape[0]):
            lw = {"ln1": seg["ln1"][l], "ln2": seg["ln2"][l],
                  **{k: v[l] for k, v in seg["attn"].items()}}
            if "moe" in seg:
                lw.update({k: (v[l] if not isinstance(v, dict) else
                               {kk: vv[l] for kk, vv in v.items()})
                           for k, v in seg["moe"].items()})
            else:
                lw["mlp"] = {k: v[l] for k, v in seg["mlp"].items()}
            layers.append(lw)
    return {"embed": params["embed"], "unembed": params["unembed"],
            "final_norm": params["final_norm"], "layers": layers}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x [S, heads, r] at positions 0..S-1: interleaved pairs regrouped into
    halves, then the rotate-half rotation (modeling_deepseek.py)."""
    S, h, r = x.shape
    x = x.view(S, h, r // 2, 2).transpose(-1, -2).reshape(S, h, r)
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32) / r)
    f = torch.outer(torch.arange(S, dtype=torch.float32), inv)
    emb = torch.cat([f, f], dim=-1)[:, None, :]
    rot = torch.cat([-x[..., r // 2:], x[..., :r // 2]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


def attention(p, x, cfg):
    S = x.shape[0]
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, c = cfg.v_head_dim, cfg.kv_lora_rank
    q = (x @ p["wq"]).view(S, H, dn + dr)
    kv_a = x @ p["wkv_a"]
    kv = (rms_norm(kv_a[:, :c], p["kv_norm"], 1e-6) @ p["wkv_b"]).view(
        S, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg.rope_theta)], -1)
    k = torch.cat([kv[..., :dn],
                   rope(kv_a[:, None, c:], cfg.rope_theta).expand(S, H, dr)],
                  -1)
    sc = torch.einsum("qhd,khd->hqk", q, k) * (dn + dr) ** -0.5
    sc = sc.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                        float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), kv[..., dn:])
    return o.reshape(S, H * dv) @ p["wo"]


def swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def route(p, x, cfg):
    """(weights [S, k], experts [S, k]): sigmoid scores, the top-k of
    scores + the selection bias, the selected scores normalised (+1e-20)
    and scaled."""
    scores = torch.sigmoid(x @ p["router"])
    _, idx = torch.topk(scores + p["score_bias"], cfg.top_k, dim=-1)
    w = torch.gather(scores, -1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor, idx


def moe(p, x, cfg):
    w, idx = route(p, x, cfg)
    out = swiglu(p["shared"], x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j])
            out[t] += w[t, j] * swiglu({k: p[k][e] for k in
                                        ("w_gate", "w_up", "w_down")}, x[t])
    return out


def logits(weights: Dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Logits [S, V] float32 of `tokens` [S] at every position."""
    x = weights["embed"][tokens.long()].float()
    for i, lw in enumerate(weights["layers"]):
        p = {k: ({kk: vv.float() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.float())
             for k, v in lw.items()}
        x = x + attention(p, rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + (swiglu(p["mlp"], h) if i < cfg.n_dense_prefix
                 else moe(p, h, cfg))
    return rms_norm(x, weights["final_norm"].float(), cfg.norm_eps) \
        @ weights["unembed"].float()
