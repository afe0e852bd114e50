"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24 -> MHA, head_dim=64)
d_ff=6144 vocab=2048 — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  The EnCodec modality frontend is a STUB per the
assignment: input_specs() provides precomputed frame token ids in the
codebook vocab.  GELU FFN, sinusoidal positions.  Full attention ->
`long_500k` skipped."""
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "musicgen-medium"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        head_dim=64, d_ff=6144, vocab_size=2048,
        act="gelu", pos="sinusoidal", frontend="embed",
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
        act="gelu", pos="sinusoidal", dtype="float32", param_dtype="float32")
