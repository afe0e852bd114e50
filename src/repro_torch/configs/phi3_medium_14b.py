"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].
Full attention -> `long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "phi3-medium-14b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        head_dim=128, d_ff=17920, vocab_size=100352,
        rope_theta=10000.0, dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=224, vocab_size=128,
        dtype="float32", param_dtype="float32")
