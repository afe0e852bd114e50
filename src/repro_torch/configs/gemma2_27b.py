"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16, head_dim=128)
d_ff=36864 vocab=256000 — local+global alternating, logit softcap
[arXiv:2408.00118; hf].  Global layers are full attention -> `long_500k`
skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "gemma2-27b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        head_dim=128, d_ff=36864, vocab_size=256000,
        attn_pattern="alt_local_global", window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norm=True, norm_plus_one=True, tie_embeddings=True,
        embed_scale=True, rope_theta=10000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256,
        attn_pattern="alt_local_global", window=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norm=True, norm_plus_one=True, tie_embeddings=True,
        embed_scale=True, dtype="float32", param_dtype="float32")
