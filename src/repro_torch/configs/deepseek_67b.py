"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch [arXiv:2401.02954; hf].
Full attention -> `long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "deepseek-67b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=102400,
        rope_theta=10000.0, dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=1, head_dim=8, d_ff=160, vocab_size=128,
        dtype="float32", param_dtype="float32")
