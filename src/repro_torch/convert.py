"""Carry parameters across from the JAX package.

The reference's params are nested dicts of arrays; converted to numpy
(`jax.device_get`) they come here unchanged in layout.  The detector's (the
stem stays HWIO, block weights stay [540, group, n_groups], `stem_bn` keeps
its running stats) go to float32 (`params_from_jax`); the LM's keep each
leaf's dtype, bfloat16 among them (`lm_params_from_jax`), so both packages
compute the same function on the same weights.
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


def lm_params_from_jax(tree: Any, device: DeviceLike = "cuda"
                       ) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    `device`, each leaf keeping its dtype.  A bfloat16 array (numpy's
    `ml_dtypes` type, named "bfloat16") crosses as its 16-bit pattern, so
    `ml_dtypes` need not be importable here."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            bits = np.array(arr).view(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(arr)).to(dev)

    return conv(tree)
