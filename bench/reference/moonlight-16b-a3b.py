"""Plain reference of Moonlight-16B-A3B (the DeepSeek-V3 block without
q-LoRA or YaRN): the full forward pass of one token sequence in float32,
TF32 off, as the published modeling code (`modeling_deepseek.py`, model
type deepseek_v3) writes it, with no cache, batching or kernels.

Weights come as plain tensors, bf16 as published or any dtype, and are
upcast to float32 one layer at a time, so the whole model needs little
room beside its bf16 weights:

    {"embed": [V, D], "unembed": [D, V], "final_norm": [D],
     "layers": [{"ln1", "ln2", "wq" [D, H*(nope+rope)], "wkv_a" [D, c+rope],
                 "kv_norm" [c], "wkv_b" [c, H*(nope+v)], "wo" [H*v, D],
                 and "mlp": {"w_gate", "w_up", "w_down"} (dense) or
                 "router" [D, E], "score_bias" [E], "w_gate"/"w_up"
                 [E, D, F], "w_down" [E, F, D], "shared": {...} (MoE)}]}

A matrix is stored [in, out] (x @ w).  `cfg` is the configuration file's
dict under the published config.json key names.

The layer, as published:
  attention: q = x W_q per head [nope | rope]; x W_kv_a = [latent | k_rope];
    latent RMS-normed (eps 1e-6, the norm's default); latent W_kv_b per
    head [k_nope | v]; rope (theta `rope_theta`) on q's and the shared
    k's rope channels, which come as interleaved pairs that the published
    code regroups into halves before the rotate-half rotation; softmax of
    q.k (nope and rope parts) x (nope + rope)^-0.5, causal; values through
    W_o.
  MLP: layers below `first_k_dense_replace` a SwiGLU of
    `intermediate_size`; the others sigmoid(x W_router), the top
    `num_experts_per_tok` of scores + `e_score_correction_bias` (selection
    only; one group), weights the selected scores normalised over them
    (+1e-20) times `routed_scaling_factor` (or, fed another
    implementation's choice of experts, those, with how far each lies
    from a top-k); each selected expert's SwiGLU
    of `moe_intermediate_size` weighted and summed, plus the shared
    experts' SwiGLU (`n_shared_experts` x `moe_intermediate_size`) on every
    token.
  RMSNorm eps `rms_norm_eps` before attention, before the MLP and at the
    end; untied unembedding.

`precision="fp8"` is the control: both operands of every matrix product
rounded to float8 e4m3 after scaling each by its largest magnitude to the
format's 448, then scaled back (the precision below the configuration's
bf16 parameters).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

#: float8 e4m3's largest finite value
FP8_MAX = 448.0
#: query rows of one block of the causal attention
Q_BLOCK = 1024


def set_precision() -> None:
    """float32 products stay float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _round_fp8(a), _round_fp8(b)
    return a @ b


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, r] at positions 0..S-1, interleaved pairs regrouped
    into halves, then rotated (rotate-half with cos/sin = [freqs, freqs])."""
    S, _, r = x.shape
    x = x.view(S, -1, r // 2, 2).transpose(-1, -2).reshape(S, -1, r)
    inv = 1.0 / theta ** (torch.arange(0, r, 2, device=x.device,
                                       dtype=torch.float32) / r)
    f = torch.outer(torch.arange(S, device=x.device, dtype=torch.float32),
                    inv)
    emb = torch.cat([f, f], dim=-1)[:, None, :]
    rot = torch.cat([-x[..., r // 2:], x[..., :r // 2]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
              precision: str) -> torch.Tensor:
    S = x.shape[0]
    H = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, c = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = _mm(x, p["wq"], precision).view(S, H, dn + dr)
    kv_a = _mm(x, p["wkv_a"], precision)
    latent = rms_norm(kv_a[:, :c], p["kv_norm"], 1e-6)
    kv = _mm(latent, p["wkv_b"], precision).view(S, H, dn + dv)
    q_pe = rope(q[..., dn:], cfg["rope_theta"])
    k_pe = rope(kv_a[:, None, c:], cfg["rope_theta"])
    q = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(0, 1)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)],
                  dim=-1).transpose(0, 1)
    v = kv[..., dn:].transpose(0, 1)
    scale = (dn + dr) ** -0.5
    out = torch.empty((H, S, dv), device=x.device)
    for lo in range(0, S, Q_BLOCK):
        hi = min(lo + Q_BLOCK, S)
        sc = _mm(q[:, lo:hi], k[:, :hi].transpose(1, 2), precision) * scale
        pos = torch.arange(lo, hi, device=x.device)[:, None]
        sc = sc.masked_fill(torch.arange(hi, device=x.device)[None] > pos,
                            float("-inf"))
        out[:, lo:hi] = _mm(torch.softmax(sc, dim=-1), v[:, :hi], precision)
    return _mm(out.transpose(0, 1).reshape(S, H * dv), p["wo"], precision)


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor,
           precision: str) -> torch.Tensor:
    h = torch.nn.functional.silu(_mm(x, p["w_gate"], precision)) \
        * _mm(x, p["w_up"], precision)
    return _mm(h, p["w_down"], precision)


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
          chosen: Optional[torch.Tensor] = None):
    """(weights [S, k], experts [S, k], how far each token's chosen set
    lies below the top-k [S]) of the published gate.  With `chosen` (the
    experts another implementation chose) those are taken, and the last
    number is the largest selection score left out minus the smallest
    taken (at most 0 where `chosen` is a top-k); without, the top-k."""
    scores = torch.sigmoid(x @ p["router"])
    sel = scores + p["score_bias"]
    if chosen is None:
        _, idx = torch.topk(sel, cfg["num_experts_per_tok"], dim=-1)
    else:
        idx = chosen.long()
    taken = torch.gather(sel, -1, idx).min(-1).values
    left = sel.scatter(-1, idx, float("-inf")).max(-1).values
    w = torch.gather(scores, -1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"], idx, left - taken


def moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
        precision: str, chosen: Optional[torch.Tensor] = None,
        stats: Optional[Dict] = None) -> torch.Tensor:
    w, idx, below = route(p, x, cfg, chosen)
    if stats is not None:
        stats.setdefault("routes", []).append(idx)
        stats.setdefault("below", []).append(below)
    out = swiglu(p["shared"], x, precision)
    for e in range(p["w_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = swiglu({k: p[k][e] for k in ("w_gate", "w_up", "w_down")},
                       x[tok], precision)
            out.index_add_(0, tok, y * w[tok, slot, None])
    return out


def logits(weights: Dict, cfg: Dict, tokens: torch.Tensor,
           positions: Sequence[int], precision: str = "float32",
           routes: Optional[Sequence[torch.Tensor]] = None,
           stats: Optional[Dict] = None) -> torch.Tensor:
    """Logits [len(positions), V] float32 of the sequence `tokens` [S] at
    `positions`.  `routes`, where given, holds each MoE layer's chosen
    experts [S, k] (the program's), which the layers then take; `stats`,
    where given, gets per MoE layer the experts taken ("routes") and how
    far each token's set lies below the top-k ("below", `route`)."""
    set_precision()
    eps = cfg["rms_norm_eps"]
    x = weights["embed"][tokens.long()].float()
    layers: List[Dict] = weights["layers"]
    for i, lw in enumerate(layers):
        p = _f32(lw)
        x = x + attention(p, rms_norm(x, p["ln1"], eps), cfg, precision)
        h = rms_norm(x, p["ln2"], eps)
        dense = cfg["first_k_dense_replace"]
        x = x + (swiglu(p["mlp"], h, precision) if i < dense else
                 moe(p, h, cfg, precision,
                     None if routes is None else routes[i - dense], stats))
        del p
    h = rms_norm(x[list(positions)], weights["final_norm"].float(), eps)
    return _mm(h, weights["unembed"].float(), precision)
