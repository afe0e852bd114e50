"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8, head_dim=128)
d_ff=2048 (per expert) vocab=163840, MoE 384 experts top-8, one dense
prefix layer — trillion-param MoE (paper-table) [arXiv:2501.kimi2;
unverified].  Full attention -> `long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "kimi-k2-1t-a32b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=2048, vocab_size=163840,
        moe=True, n_experts=384, top_k=8, n_dense_prefix=1,
        rope_theta=50000.0, dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
        moe=True, n_experts=8, top_k=2, n_dense_prefix=1,
        dtype="float32", param_dtype="float32")
