"""Dense MLP blocks (SwiGLU / GELU), the reference's `repro.models.mlp`."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, checkpoint_name, silu
from repro_torch.models.lm_config import LMConfig


def mlp_specs(cfg: LMConfig, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    pd = cfg.pdtype
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec((d, ff), ("embed", "mlp"), dtype=pd),
            "w_up": ParamSpec((d, ff), ("embed", "mlp"), dtype=pd),
            "w_down": ParamSpec((ff, d), ("mlp", "embed"), dtype=pd),
        }
    return {
        "w_up": ParamSpec((d, ff), ("embed", "mlp"), dtype=pd),
        "w_down": ParamSpec((ff, d), ("mlp", "embed"), dtype=pd),
    }


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: LMConfig) -> torch.Tensor:
    """SwiGLU: silu(x W_gate) * (x W_up) W_down; GELU: gelu(x W_up) W_down,
    gelu's tanh approximation.  The gate and up projections are tagged for
    remat "names"."""
    dt = x.dtype
    if cfg.act == "swiglu":
        with checkpoint_name("mlp_gate"):
            gate = x @ params["w_gate"].to(dt)
        with checkpoint_name("mlp_up"):
            up = x @ params["w_up"].to(dt)
        h = silu(gate) * up
    else:
        with checkpoint_name("mlp_up"):
            up = x @ params["w_up"].to(dt)
        # `jax.nn.gelu` defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"].to(dt)
