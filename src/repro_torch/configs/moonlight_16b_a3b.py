"""moonlight-16b-a3b [mla, moe]: 27L d_model=2048 16H MLA (kv_lora_rank
512, qk_nope 128, qk_rope 64, v_head 128, no q-LoRA), a dense SwiGLU first
layer of 11,264, then 64 routed experts of 1,408 top-6 plus 2 shared,
sigmoid routing with a selection-only correction bias, normalised top-6
weights scaled by 2.446, vocab=163840 untied, rope theta 50,000, 8,192
positions [hf:moonshotai/Moonlight-16B-A3B config.json].  15.96 B
parameters, bf16 as published.  A port-only architecture: the JAX
package has no twin."""
from repro_torch.models.lm_config import MLAConfig

ARCH_ID = "moonlight-16b-a3b"


def full() -> MLAConfig:
    return MLAConfig(
        name=ARCH_ID, n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=192, d_ff=1408, vocab_size=163840, block="mla",
        moe=True, n_experts=64, top_k=6, n_dense_prefix=1,
        rope_theta=50000.0, norm_eps=1e-5, dtype="bfloat16",
        param_dtype="bfloat16", kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, dense_d_ff=11264,
        n_shared_experts=2, routed_scaling_factor=2.446)


def smoke() -> MLAConfig:
    return MLAConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=24, d_ff=32, vocab_size=128, block="mla",
        moe=True, n_experts=8, top_k=3, n_dense_prefix=1,
        rope_theta=50000.0, norm_eps=1e-5, dtype="float32",
        param_dtype="float32", kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, dense_d_ff=96,
        n_shared_experts=2, routed_scaling_factor=2.446)
