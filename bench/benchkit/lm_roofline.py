"""Multiply-accumulates of the MLA block's language model (the DeepSeek-V3
block of `bench/configs/moonlight-16b-a3b.json`), from the configuration's
published keys, for the LM cells' MFU.

A token costs every projection of every layer (the latent attention's
W_q, W_kv_a, W_kv_b and W_o; the dense first layers' SwiGLU; the routed
layers' router, its `num_experts_per_tok` experts and the shared ones)
and the unembedding, but not the embedding's lookup: 2,579,103,744 at
Moonlight's widths.  Attention adds its context term, counted in the
expanded form the model defines (q.k over the no-position and rope head
parts, then the values): heads x (nope + rope + v) a key and layer.
"""
from __future__ import annotations

from typing import Dict


def token_macs(cfg: Dict) -> int:
    """Multiply-accumulates of one token outside attention's context
    term and the embedding."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, c = cfg["v_head_dim"], cfg["kv_lora_rank"]
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    F = cfg["moe_intermediate_size"]
    attn = D * H * (dn + dr) + D * (c + dr) + c * H * (dn + dv) + H * dv * D
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    moe = 3 * D * F * experts + D * cfg["n_routed_experts"]
    return (L * attn + dense * 3 * D * cfg["intermediate_size"]
            + (L - dense) * moe + D * cfg["vocab_size"])


def context_macs(cfg: Dict, keys: int) -> int:
    """Attention's multiply-accumulates of one token over `keys` keys, in
    every layer."""
    per_key = cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"]
                                            + cfg["qk_rope_head_dim"]
                                            + cfg["v_head_dim"])
    return cfg["num_hidden_layers"] * per_key * keys


def request_macs(cfg: Dict, prompt: int, answer: int) -> int:
    """Multiply-accumulates of one request: its `prompt` tokens and the
    `answer` - 1 answer tokens fed back, the token at position p attending
    to p + 1 keys."""
    n = prompt + max(answer - 1, 0)
    return n * token_macs(cfg) + context_macs(cfg, n * (n + 1) // 2)
