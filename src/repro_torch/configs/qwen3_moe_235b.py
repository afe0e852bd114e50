"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4, head_dim=128)
d_ff=1536 (per expert) vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf].  Full attention -> `long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        head_dim=128, d_ff=1536, vocab_size=151936,
        moe=True, n_experts=128, top_k=8, qk_norm=True,
        rope_theta=1000000.0, dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
        moe=True, n_experts=8, top_k=2, qk_norm=True,
        dtype="float32", param_dtype="float32")
