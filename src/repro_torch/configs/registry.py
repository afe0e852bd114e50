"""Architecture registry: ``--arch <id>`` resolution for the launch tools,
and the reference's liveness map, value for value.

`list_archs()` and `ARCH_STATUS` are the reference's ten; the port's own
architectures (`PORT_ARCHS`, no twin in the JAX package) resolve through
`get_config` beside them and are listed by `all_archs()`."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.models.lm_config import LMConfig
from repro_torch.configs import (hymba_1p5b, phi3_medium_14b,
                                 deepseek_67b, gemma2_27b, llama3_405b,
                                 qwen3_moe_235b, kimi_k2_1t, musicgen_medium,
                                 rwkv6_3b, chameleon_34b,
                                 moonlight_16b_a3b)

_MODULES = {
    m.ARCH_ID: m for m in (
        hymba_1p5b, phi3_medium_14b, deepseek_67b, gemma2_27b, llama3_405b,
        qwen3_moe_235b, kimi_k2_1t, musicgen_medium, rwkv6_3b, chameleon_34b)
}

# architectures of the port alone, outside the reference's registry
PORT_ARCHS = {m.ARCH_ID: m for m in (moonlight_16b_a3b,)}

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


def all_archs() -> List[str]:
    """The reference's architectures, then the port's own."""
    return list_archs() + sorted(PORT_ARCHS)


def get_config(arch: str, variant: str = "full") -> LMConfig:
    mod = _MODULES.get(arch) or PORT_ARCHS.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; known: {all_archs()}")
    if variant == "full":
        return mod.full()
    if variant == "smoke":
        return mod.smoke()
    raise ValueError(f"unknown variant {variant!r}")
