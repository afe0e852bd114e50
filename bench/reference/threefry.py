"""A frozen copy of the Threefry-2x32 arithmetic that `jax.random` keys
dies with, in plain int64 torch ops, under the partitionable counter
layout (JAX's default from 0.5 on).

A key is an int64 tensor whose last axis holds the two 32-bit key words;
leading axes batch keys.  For `n` words under one key, word i is o0 ^ o1 of
the block at counters (i >> 32, i & mask); `split(key, num)` gives key i =
(o0, o1) at counters (0, i); `fold_in(key, d)` is the block at (0, d).

The draws' tails are written in float64 and rounded to float32 once: the
uniform of the normal, 2 f + nextafter(-1, 0) with f the word's top 23 bits
as a fraction, is exact in float32, and erf_inv, exp and the normal cdf
are float64 library calls.  So a draw here can differ from a float32
implementation of the same tail in its last bit, never more.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
#: the normal's uniform starts here, above -1 (float32 nextafter(-1, 0))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def block(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
          x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on int64 words,
    broadcasting; returns the two output words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2) & MASK32
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: (seed >> 32, seed & mask)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`; key axes and data axes broadcast."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    o0, o1 = block(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: [..., 2] -> [..., num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    o0, o1 = block(k[..., 0, None], k[..., 1, None], torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def words(k: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Words start..stop-1 of the stream under each key: [..., stop-start].
    Word i of a draw of shape S is element i of S in row-major order, so a
    slice of rows of a draw is a slice of its words."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=k.device)
    o0, o1 = block(k[..., 0, None], k[..., 1, None], idx >> 32, idx & MASK32)
    return o0 ^ o1


def _unit(w: torch.Tensor) -> torch.Tensor:
    """Top 23 bits of each word as a float64 fraction in [0, 1)."""
    return (w >> 9).to(torch.float64) * (2.0 ** -23)


def normal_from_words(w: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """`scale * jax.random.normal` of these words, as float64 (not yet
    rounded): sqrt(2) erf_inv(u), u = 2 f + nextafter(-1, 0)."""
    u = 2.0 * _unit(w) + NORMAL_LO
    return torch.special.erfinv(u) * (float(np.float32(scale)) * _SQRT2_F32)


def normal(k: torch.Tensor, start: int, stop: int,
           scale: float = 1.0) -> torch.Tensor:
    """Words start..stop-1 of `jax.random.normal(k, ...)` (float32)."""
    return normal_from_words(words(k, start, stop), scale).float()


def lognormal(k: torch.Tensor, shape: Sequence[int],
              sigma: float) -> torch.Tensor:
    """exp(sigma z), z `jax.random.normal(k, shape)`: [..., *shape]."""
    n = math.prod(shape)
    z = normal_from_words(words(k, 0, n), sigma)
    return torch.exp(z).float().reshape(k.shape[:-1] + tuple(shape))


def bernoulli_half(k: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Words start..stop-1 of `jax.random.bernoulli(k, 0.5, ...)`: the
    uniform f < 0.5, i.e. the word's top bit clear, as float32 {0, 1}."""
    return ((words(k, start, stop) >> 31) == 0).float()


def measured(k: torch.Tensor, shape: Sequence[int], xp: Sequence[float],
             fp: Sequence[float]) -> torch.Tensor:
    """`jnp.interp(norm.cdf(jax.random.normal(k, shape)), xp, fp)`: the
    measured device's inverse-CDF mask, float64 throughout, one float32
    rounding at the end; [..., *shape]."""
    n = math.prod(shape)
    z = normal_from_words(words(k, 0, n))
    u = torch.special.ndtr(z)
    xs = torch.tensor(np.asarray(xp, np.float32), dtype=torch.float64,
                      device=k.device)
    fs = torch.tensor(np.asarray(fp, np.float32), dtype=torch.float64,
                      device=k.device)
    j = torch.clamp(torch.searchsorted(xs, u, right=True) - 1, 0,
                    xs.numel() - 2)
    x0, x1, f0, f1 = xs[j], xs[j + 1], fs[j], fs[j + 1]
    t = torch.clamp((u - x0) / (x1 - x0), 0.0, 1.0)
    val = f0 + t * (f1 - f0)
    val = torch.where(u <= xs[0], fs[0], torch.where(u >= xs[-1], fs[-1], val))
    return val.float().reshape(k.shape[:-1] + tuple(shape))
