"""Assigned input shapes (same 4 for every LM arch; 40 cells total).

``train_4k`` lowers train_step; ``prefill_32k`` lowers the prefill forward;
``decode_32k`` / ``long_500k`` lower serve_step (one new token against a KV
cache of seq_len).  ``long_500k`` requires sub-quadratic attention — it runs
for SSM/hybrid archs (hymba, rwkv6) and is SKIPPED for pure full-attention
archs (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.models.lm_config import LMConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: LMConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("full quadratic attention at 524k context; assigned "
                       "skip for pure full-attention archs (sub-quadratic "
                       "only: hymba/rwkv6)")
    return True, ""
