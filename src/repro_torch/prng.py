"""Threefry-2x32 counter-based PRNG in PyTorch, bit-compatible with
`jax.random` under either threefry scheme.

The whole system's reproducibility rests on JAX's stateless key discipline:
chip `c`, layer `s*10+b`, group `g` of a population is keyed by
`fold_in(fold_in(fold_in(key, c), s*10+b), g)`, so a chip's draws never depend
on chunking or on the rest of the population.  Porting the generator bit for
bit makes chip `c` of this package the same die as chip `c` of the JAX
package.

Representation: a key is an int64 tensor whose last axis holds the two
32-bit key words; leading axes batch keys (a `[chips, 2]` tensor is what
`jax.vmap` over chip ids produces).  Nothing here holds RNG state.

The scheme: JAX lays out threefry's counters in one of two ways, chosen by
its flag `jax_threefry_partitionable` (True by default from jax 0.5).  This
module follows one process-wide setting of its own, with the same default,
read at import from the environment variable `JAX_THREEFRY_PARTITIONABLE`
when that is set (so one environment puts both packages on one scheme), and
changed by `set_threefry_partitionable` or, for a block, the context manager
`threefry_partitionable`, as `jax.config.update(...)` and
`jax.threefry_partitionable(...)` change JAX's.  For `n` words under one key:
  * partitionable: word i is o0 ^ o1 of the block at counters (i >> 32,
    i & mask); `split(key, num)` gives key i = (o0, o1) at counters (0, i);
  * original: the counters iota(n), padded with one 0 when n is odd, are
    cut into halves x0 and x1; the blocks at (x0[j], x1[j]) give o0 and o1,
    and the words are concat(o0, o1)[:n]; `split(key, num)` is those words
    for n = 2 * num, read as [num, 2];
  * `fold_in(key, d)` is the block at (0, d) in both.
Batched keys use the same counters for every key.

Each draw is one entry point of `repro_torch.kernels.ops`: a key on the CPU
takes the plain versions here (`*_plain`: the block function in int64 torch
ops with `& 0xFFFFFFFF` masks, about 170 elementwise ops per call, on any
device), a key on the card one launch of a hand-written kernel
(`csrc/threefry.cu`) that gives the same bits.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import xla_order as xo
from repro_torch.runtime import resolve_device

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
#: the environment variable JAX reads its flag from, read here too
SCHEME_ENV = "JAX_THREEFRY_PARTITIONABLE"

IntLike = Union[int, torch.Tensor]


def _env_flag(default: bool = True) -> bool:
    """The scheme named by `SCHEME_ENV`, parsed as JAX parses it."""
    val = os.environ.get(SCHEME_ENV, str(default)).lower()
    if val in ("y", "yes", "t", "true", "on", "1"):
        return True
    if val in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {val!r} for environment "
                     f"{SCHEME_ENV!r}")


_PARTITIONABLE = _env_flag()


def is_partitionable() -> bool:
    """The scheme in force: True for partitionable, False for original."""
    return _PARTITIONABLE


def set_threefry_partitionable(flag: bool) -> None:
    """Put the whole process on one scheme (jax's
    `config.update("jax_threefry_partitionable", flag)`)."""
    global _PARTITIONABLE
    _PARTITIONABLE = bool(flag)


@contextlib.contextmanager
def threefry_partitionable(flag: bool) -> Iterator[None]:
    """The scheme `flag` for the block, the earlier one restored after it
    (jax's `threefry_partitionable(flag)`)."""
    before = _PARTITIONABLE
    set_threefry_partitionable(flag)
    try:
        yield
    finally:
        set_threefry_partitionable(before)


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


def _ops():
    from repro_torch.kernels import ops
    return ops


# ------------------------------------------------------------ entry points

def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`.  `data` may be an int or an integer
    tensor; key batch axes and data axes broadcast (a `[2]` key folded with
    `[chips]` ids gives `[chips, 2]`, as `vmap` over the ids would)."""
    return _ops().threefry_fold_in(key, data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: `[..., 2]` -> `[..., num, 2]`."""
    return _ops().threefry_split(key, num)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit `jax.random.bits(key, shape)` as int64 values in [0, 2**32).

    Key batch axes lead the result: keys `[chips, 2]` and shape `(B, N)`
    give `[chips, B, N]`, bit-identical to `vmap(bits)` over the keys."""
    return _ops().threefry_draw(key, shape, "bits")


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return _ops().threefry_draw(key, shape, "uniform", minval=minval,
                                maxval=maxval)


def normal(key: torch.Tensor, shape: Sequence[int],
           scale: float = 1.0) -> torch.Tensor:
    """`scale * jax.random.normal(key, shape, float32)` as one jit computes
    it: sqrt(2) * erf_inv(u) with u uniform on (nextafter(-1, 0), 1), and a
    constant `scale` folded into the constant sqrt(2) (XLA's algebraic
    simplifier multiplies the two float32 constants first); XLA's float32
    erf_inv (`xla_order.erf_inv_plain`)."""
    return _ops().threefry_draw(key, shape, "normal", scale=scale)


def lognormal(key: torch.Tensor, shape: Sequence[int],
              sigma: float) -> torch.Tensor:
    """`jnp.exp(sigma * jax.random.normal(key, shape))` under one jit: the
    device-variation mask, `normal(key, shape, scale=sigma)` through XLA's
    float32 exp (`xla_order.exp_plain`)."""
    return _ops().threefry_draw(key, shape, "lognormal", scale=sigma)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` as float32 {0, 1}."""
    return _ops().threefry_draw(key, shape, "bernoulli", p=p)


def measured(key: torch.Tensor, shape: Sequence[int], table: Table
             ) -> torch.Tensor:
    """`jnp.interp(norm.cdf(jax.random.normal(key, shape)), xp, fp)` under
    one jit, table = (xp, fp): the measured device backend's variation
    mask, an inverse-CDF draw through a quantile table (`tail_plain`'s
    "measured")."""
    return _ops().threefry_draw(key, shape, "measured", table=table)


#: float32's smallest normal, the gumbel's uniform's floor
F32_TINY = float(np.finfo(np.float32).tiny)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): `split`
    into k1, k2, 32 bits under each, and `jax._src.random._randint`'s span
    arithmetic in wrapping uint32 (with a span above 2**16, 2**32 % span
    wraps to 0 and the first draw drops out, as it does there)."""
    info = np.iinfo(np.int32)
    out_of_range = maxval > info.max
    lo = min(max(int(minval), info.min), info.max)
    hi = min(max(int(maxval), info.min), info.max)
    span = (hi - lo) & MASK32 if hi > lo else 1
    if out_of_range and hi > lo:
        span = (span + 1) & MASK32

    def rem(a, b):                 # XLA's unsigned remainder: x rem 0 = x
        return a if b == 0 else a % b
    mult = rem((rem(1 << 16, span) ** 2) & MASK32, span)
    keys = split(key, 2)
    high = random_bits(keys[..., 0, :], shape)
    low = random_bits(keys[..., 1, :], shape)
    offset = ((rem(high, span) * mult) & MASK32) + rem(low, span)
    offset = rem(offset & MASK32, span)
    # int32(offset) + minval in wrapping int32
    val = (offset + lo) & MASK32
    return torch.where(val > info.max, val - (1 << 32), val).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, float32)` (mode "low"):
    -log(-log(u)) with u `uniform(key, shape, finfo.tiny, 1)`, XLA's
    float32 log (`xla_order.log`)."""
    u = uniform(key, shape, minval=F32_TINY, maxval=1.0)
    return -xo.log(-xo.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis)` for float32 logits,
    sampling with replacement: the argmax of `gumbel + logits` (the first
    index of the maximum, as `jnp.argmax`), int64."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical takes float32 logits, got "
                         f"{logits.dtype}")
    g = gumbel(key.to(logits.device), tuple(logits.shape))
    return torch.argmax(g + logits, dim=axis)


# ---------------------------------------------------------- plain versions

def _as_words(data: IntLike, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & MASK32
    return torch.tensor(int(data) & MASK32, dtype=torch.int64, device=device)


def check_words(n: int) -> None:
    """Raise for a draw of `n` words under one key that the port does not
    take: the original scheme switches to split keys from 2**32 - 1 words
    on, and the kernel's counters are 32-bit."""
    limit = MASK32 if not _PARTITIONABLE else MASK32 + 1
    if n >= limit:
        raise NotImplementedError(
            f"{n} words under one key: the port draws fewer than {limit}")


def _halves(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The original scheme's counters for n words: iota(n), padded with one
    0 when n is odd, cut into halves."""
    h = (n + 1) // 2
    x0 = torch.arange(h, dtype=torch.int64, device=device)
    x1 = x0 + h
    return x0, torch.where(x1 < n, x1, torch.zeros_like(x1))


def _original_words(key: torch.Tensor, n: int) -> torch.Tensor:
    """`n` words per key, [..., n], under the original scheme."""
    x0, x1 = _halves(n, key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None], x0, x1)
    return torch.cat([o0, o1], dim=-1)[..., :n]


def fold_in_plain(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """Plain version of `fold_in`, on any device (both schemes)."""
    d = _as_words(data, key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """Plain version of `split`, on any device."""
    check_words(num if _PARTITIONABLE else 2 * num)
    if not _PARTITIONABLE:
        words = _original_words(key, 2 * num)
        return words.reshape(key.shape[:-1] + (num, 2))
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    o0, o1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits_plain(key: torch.Tensor, shape: Sequence[int]
                      ) -> torch.Tensor:
    """Plain version of `random_bits`, on any device."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lead = key.shape[:-1]
    check_words(n)
    if not _PARTITIONABLE:
        return _original_words(key, n).reshape(lead + shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    o0, o1 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return (o0 ^ o1).reshape(lead + shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform_consts(minval: float, maxval: float) -> Tuple[float, float]:
    """(float32 minval, float32 maxval - minval): the constants of the
    uniform's f * (hi - lo) + lo, subtracted in float32 as jax does."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), float(np.float32(hi - lo))


#: the normal's uniforms start here, above -1
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))
#: sqrt(1/2): the measured tail's normal is at this scale (the cdf's w)
HALF_SQRT2 = xo.HALF_SQRT2


def normal_factor(scale: float) -> float:
    """float32(scale * float32(sqrt 2)): XLA folds a constant scale into
    the normal's constant sqrt(2) before it multiplies erf_inv(u)."""
    return float(np.float32(np.float32(scale) * np.float32(_SQRT2_F32)))


#: the draws' tails: what each word becomes
TAILS = ("bits", "uniform", "normal", "lognormal", "bernoulli", "measured")
#: the measured tail's table: (quantiles xp, factors fp), Python floats
Table = Tuple[Sequence[float], Sequence[float]]
#: the most quantiles a measured tail's table may hold (the kernel's room)
MAX_TABLE = 32


def check_table(table: Table) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """The measured tail's table as two tuples of float32 values (the
    rounding `jnp.asarray(..., float32)` gives them); raises unless they
    are aligned and hold 2 to `MAX_TABLE` points, every value and every
    float32 difference of neighbours is finite, and the quantiles do not
    decrease (`jnp.interp`'s terms; ties are empty intervals)."""
    if table is None:
        raise ValueError("the measured tail needs table=(xp, fp)")
    xa, fa = (np.asarray(t, np.float32).ravel() for t in table)
    if len(xa) != len(fa) or not 2 <= len(xa) <= MAX_TABLE:
        raise ValueError(f"a measured table needs 2 to {MAX_TABLE} aligned "
                         f"(quantile, factor) points, got {len(xa)} and "
                         f"{len(fa)}")
    with np.errstate(over="ignore", invalid="ignore"):
        steps = np.concatenate([np.diff(xa), np.diff(fa)])
    if not (np.isfinite(xa).all() and np.isfinite(fa).all()
            and np.isfinite(steps).all() and (np.diff(xa) >= 0).all()):
        raise ValueError("a measured table needs finite values, finite "
                         "float32 steps between neighbours and quantiles "
                         "that do not decrease")
    return (tuple(float(v) for v in xa), tuple(float(v) for v in fa))


def tail_consts(tail: str, minval: float = 0.0, maxval: float = 1.0
                ) -> Tuple[float, float]:
    """`uniform_consts` of a draw's tail: the normal's uniform is on
    (nextafter(-1, 0), 1), bernoulli's on [0, 1); raises for an unknown
    tail."""
    if tail not in TAILS:
        raise ValueError(f"unknown draw {tail!r}, not one of {TAILS}")
    if tail in ("normal", "lognormal", "measured"):
        minval, maxval = NORMAL_LO, 1.0
    elif tail == "bernoulli":
        minval, maxval = 0.0, 1.0
    return uniform_consts(minval, maxval)


def tail_plain(words: torch.Tensor, tail: str, *, minval: float = 0.0,
               maxval: float = 1.0, scale: float = 1.0,
               p: float = 0.5, table: Table = None) -> torch.Tensor:
    """Words (int64 values in [0, 2**32)) through one draw's tail, on any
    device; every tail but "bits" reads only a word's top 23 bits:
      * "uniform": f * (hi - lo) + lo as one fused multiply-add (XLA
        contracts it inside `jax.random.uniform`'s jit; with lo = 0 that is
        the product's own rounding), clamped below at lo, f the top 23 bits
        as a float in [0, 1);
      * "normal": `scale * jax.random.normal`, the uniform on
        (nextafter(-1, 0), 1) through XLA's float32 erf_inv
        (`xla_order.erf_inv_plain`) times float32(scale * float32(sqrt 2));
      * "lognormal": exp of the normal at scale = sigma
        (`xla_order.exp_plain`), the device-variation mask;
      * "bernoulli": the uniform on [0, 1) below p, as float32 {0, 1};
      * "measured": the normal z through `jax.scipy.stats.norm.cdf` and
        `jnp.interp` over table = (xp, fp) (`xla_order.ndtr_from_w`,
        `xla_order.interp`); the cdf's w = z sqrt(1/2) is the normal at
        scale sqrt(1/2), the two constants folded into one as XLA folds
        them;
      * "bits": the words themselves."""
    lo, span = tail_consts(tail, minval, maxval)
    if tail == "bits":
        return words
    floats = _bits_to_unit_float(words)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=words.device)
    u = floats * span if lo == 0.0 else xo.fma_plain(floats, span, lo)
    u = torch.maximum(lo_t, u)
    if tail == "uniform":
        return u
    if tail == "bernoulli":
        return (u < torch.tensor(p, dtype=torch.float32,
                                 device=words.device)).float()
    if tail == "measured":
        xp, fp = (torch.tensor(t, dtype=torch.float32, device=words.device)
                  for t in check_table(table))
        w = xo.erf_inv_plain(u, normal_factor(HALF_SQRT2))
        return xo.interp(xo.ndtr_from_w(w), xp, fp)
    v = xo.erf_inv_plain(u, normal_factor(scale))
    return xo.exp_plain(v) if tail == "lognormal" else v


def uniform_plain(key: torch.Tensor, shape: Sequence[int],
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Plain version of `uniform`, on any device."""
    return tail_plain(random_bits_plain(key, shape), "uniform",
                      minval=minval, maxval=maxval)


def normal_plain(key: torch.Tensor, shape: Sequence[int],
                 scale: float = 1.0) -> torch.Tensor:
    """Plain version of `normal`, on any device."""
    return tail_plain(random_bits_plain(key, shape), "normal", scale=scale)


def lognormal_plain(key: torch.Tensor, shape: Sequence[int],
                    sigma: float) -> torch.Tensor:
    """Plain version of `lognormal`, on any device."""
    return tail_plain(random_bits_plain(key, shape), "lognormal",
                      scale=sigma)


def bernoulli_plain(key: torch.Tensor, p: float, shape: Sequence[int]
                    ) -> torch.Tensor:
    """Plain version of `bernoulli`, on any device."""
    return tail_plain(random_bits_plain(key, shape), "bernoulli", p=p)


def measured_plain(key: torch.Tensor, shape: Sequence[int], table: Table
                   ) -> torch.Tensor:
    """Plain version of `measured`, on any device."""
    return tail_plain(random_bits_plain(key, shape), "measured", table=table)
