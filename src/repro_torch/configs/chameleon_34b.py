"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8, head_dim=128)
d_ff=22016 vocab=65536 — early-fusion, VQ image tokens
[arXiv:2405.09818; unverified].  Early fusion means the modality frontend
IS the unified token embedding: the VQ tokenizer is a stub per the
assignment and input_specs() provides precomputed token ids (text + image
VQ codes share the 65536 vocab).  QK-norm for stability.  Full attention ->
`long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "chameleon-34b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=65536,
        qk_norm=True, rope_theta=10000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=128,
        qk_norm=True, dtype="float32", param_dtype="float32")
