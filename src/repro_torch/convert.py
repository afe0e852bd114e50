"""Carry parameters across from the JAX package.

The reference's detector params are a nested dict of arrays; converted to
numpy (`jax.device_get`) they come here unchanged in layout — the stem stays
HWIO, block weights stay [540, group, n_groups], `stem_bn` keeps its running
stats — so both packages compute the same function on the same weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.runtime import DeviceLike, resolve_device


def params_from_jax(tree: Any, device: DeviceLike = "cuda"
                    ) -> Dict[str, Any]:
    """Nested dict of numpy arrays (or array-likes) -> the same nested dict
    of float32 tensors on `device`."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)
        return torch.from_numpy(arr).to(dev)

    return conv(tree)
