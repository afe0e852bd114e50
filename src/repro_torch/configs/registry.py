"""Architecture registry: ``--arch <id>`` resolution for the launch tools,
and the reference's liveness map, value for value."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.models.lm_config import LMConfig
from repro_torch.configs import (hymba_1p5b, phi3_medium_14b,
                                 deepseek_67b, gemma2_27b, llama3_405b,
                                 qwen3_moe_235b, kimi_k2_1t, musicgen_medium,
                                 rwkv6_3b, chameleon_34b)

_MODULES = {
    m.ARCH_ID: m for m in (
        hymba_1p5b, phi3_medium_14b, deepseek_67b, gemma2_27b, llama3_405b,
        qwen3_moe_235b, kimi_k2_1t, musicgen_medium, rwkv6_3b, chameleon_34b)
}

# Liveness of every registered arch, as the reference records it for its
# static analysis:
#   "live"   — on the paper's detector/MC path
#   "legacy" — the LM model zoo
ARCH_STATUS: Dict[str, str] = {
    "yolo-irc": "live",
    **{arch: "legacy" for arch in _MODULES},
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_config(arch: str, variant: str = "full") -> LMConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = _MODULES[arch]
    if variant == "full":
        return mod.full()
    if variant == "smoke":
        return mod.smoke()
    raise ValueError(f"unknown variant {variant!r}")
