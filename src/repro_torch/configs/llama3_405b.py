"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8, head_dim=128)
d_ff=53248 vocab=128256 — GQA 128k vocab [arXiv:2407.21783; unverified].
Full attention -> `long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "llama3-405b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        head_dim=128, d_ff=53248, vocab_size=128256,
        rope_theta=500000.0, dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=128, n_heads=8,
        n_kv_heads=1, head_dim=16, d_ff=416, vocab_size=256,
        rope_theta=500000.0, dtype="float32", param_dtype="float32")
