"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5, head_dim=64)
d_ff=5504 vocab=32001, ssm_state=16 — parallel attn+mamba heads
[arXiv:2411.13676; hf].  Sliding-window attention on most layers (global at
first/middle/last), so `long_500k` RUNS."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "hymba-1.5b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001,
        block="hybrid", attn_pattern="local_mostly", window=1024,
        ssm_state=16, rope_theta=10000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=80, n_heads=5,
        n_kv_heads=1, head_dim=16, d_ff=160, vocab_size=128,
        block="hybrid", attn_pattern="local_mostly", window=8,
        ssm_state=4, dtype="float32", param_dtype="float32")
