"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free, head_size 64 -> 40 heads)
d_ff=8960 vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892; hf].
O(1) decode state -> `long_500k` RUNS."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "rwkv6-3b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        head_dim=64, d_ff=8960, vocab_size=65536,
        block="rwkv", pos="none", dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=224, vocab_size=128,
        block="rwkv", pos="none", dtype="float32", param_dtype="float32")
