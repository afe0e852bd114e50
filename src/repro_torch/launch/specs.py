"""input_specs(): stand-ins for every model input of every (arch x shape)
cell (the reference's `repro.launch.specs`, whose `ShapeDtypeStruct`s are
tensors here): `torch.empty` on `device`, so a `meta` device (the default)
or an open `FakeTensorMode` allocates nothing.

For modality archs ([audio] musicgen / [vlm] chameleon) the frontend is a
stub, as in the reference: inputs are precomputed token ids in the model's
vocab (EnCodec frames / unified text+VQ codes respectively).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.lm_config import LMConfig
from repro_torch.models.transformer import LM

PyTree = Any


def _tokens(B: int, S: int, device) -> torch.Tensor:
    return torch.empty((B, S), dtype=torch.int32, device=device)


def train_input_specs(cfg: LMConfig, shape: ShapeSpec,
                      device="meta") -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(B, S, device), "labels": _tokens(B, S, device)}


def prefill_input_specs(cfg: LMConfig, shape: ShapeSpec,
                        device="meta") -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(B, S, device)}


def decode_input_specs(lm: LM, shape: ShapeSpec, device="meta"
                       ) -> Tuple[torch.Tensor, PyTree]:
    """(tokens [B,1], the KV/state cache sized for shape.seq_len, built by
    `LM.init_cache` on `device`)."""
    B = shape.global_batch
    cache = lm.init_cache(B, shape.seq_len, device=device)
    return _tokens(B, 1, device), cache


def input_specs(lm: LM, shape: ShapeSpec, device="meta") -> Dict[str, Any]:
    """Unified entry: the dict of abstract inputs the shape's step takes."""
    if shape.kind == "train":
        return {"batch": train_input_specs(lm.cfg, shape, device)}
    if shape.kind == "prefill":
        return {"batch": prefill_input_specs(lm.cfg, shape, device)}
    tokens, cache = decode_input_specs(lm, shape, device)
    return {"tokens": tokens, "cache": cache}
