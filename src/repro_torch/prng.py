"""Threefry-2x32 counter-based PRNG in PyTorch, bit-compatible with
`jax.random` under `jax_threefry_partitionable=True` (the default of jax >= 0.5).

The whole system's reproducibility rests on JAX's stateless key discipline:
chip `c`, layer `s*10+b`, group `g` of a population is keyed by
`fold_in(fold_in(fold_in(key, c), s*10+b), g)`, so a chip's draws never depend
on chunking or on the rest of the population.  Porting the generator bit for
bit makes chip `c` of this package the same die as chip `c` of the JAX
package.

Representation: a key is an int64 tensor whose last axis holds the two
32-bit key words; leading axes batch keys (a `[chips, 2]` tensor is what
`jax.vmap` over chip ids produces).  All 32-bit arithmetic runs in int64
with `& 0xFFFFFFFF` masks, because torch's uint32 support is thin.  Every
function is plain elementwise torch and runs on whatever device the key lives
on; nothing here holds global RNG state.

Only the partitionable scheme is implemented: with
`jax_threefry_partitionable=False` JAX draws different bits from `split` and
`random_bits`, and this module would not match it.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import xla_order as xo
from repro_torch.runtime import resolve_device

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def _rounds(x0: torch.Tensor, x1: torch.Tensor, rots) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
    for r in rots:
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds), broadcasting over its
    four int64 word arguments; returns the two output words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2) & MASK32
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT_A if i % 2 == 0 else _ROT_B)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device: Union[str, torch.device] = "cuda"
            ) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the key words (seed >> 32, seed & mask),
    on the card unless `device` says otherwise."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=resolve_device(device))


def _as_words(data: IntLike, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & MASK32
    return torch.tensor(int(data) & MASK32, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`.  `data` may be an int or an integer
    tensor; key batch axes and data axes broadcast (a `[2]` key folded with
    `[chips]` ids gives `[chips, 2]`, as `vmap` over the ids would)."""
    d = _as_words(data, key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: `[..., 2]` -> `[..., num, 2]`."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    o0, o1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit `jax.random.bits(key, shape)` as int64 values in [0, 2**32).

    Key batch axes lead the result: keys `[chips, 2]` and shape `(B, N)`
    give `[chips, B, N]`, bit-identical to `vmap(bits)` over the keys."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    o0, o1 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return (o0 ^ o1).reshape(lead + shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    floats = _bits_to_unit_float(random_bits(key, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: Sequence[int],
           scale: float = 1.0) -> torch.Tensor:
    """`scale * jax.random.normal(key, shape, float32)` as one jit computes
    it: sqrt(2) * erf_inv(u) with u uniform on (nextafter(-1, 0), 1), and a
    constant `scale` folded into the constant sqrt(2) (XLA's algebraic
    simplifier multiplies the two float32 constants first).  XLA's
    erf_inv is `xla_order.erf_inv`, one kernel launch on the card."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    factor = float(np.float32(np.float32(scale) * np.float32(_SQRT2_F32)))
    return xo.erf_inv(u, factor)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` as a bool tensor."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)
