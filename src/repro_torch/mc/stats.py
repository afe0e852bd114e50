"""Streaming ensemble statistics on the host: Welford moments + exact
quantiles, in numpy float32 (the reference keeps the same state in f32)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Sequence

import numpy as np


class Welford(NamedTuple):
    """Running (count, mean, M2) triplet."""
    count: np.float32
    mean: np.float32
    m2: np.float32


def welford_init() -> Welford:
    """Empty running state."""
    z = np.float32(0.0)
    return Welford(count=z, mean=z, m2=z)


def welford_merge(a: Welford, b: Welford) -> Welford:
    """Chan parallel combination of two Welford states."""
    n = np.float32(a.count + b.count)
    safe_n = np.float32(max(n, np.float32(1.0)))
    delta = np.float32(b.mean - a.mean)
    mean = np.float32(a.mean + delta * b.count / safe_n)
    m2 = np.float32(a.m2 + b.m2 + delta * delta * a.count * b.count / safe_n)
    return Welford(count=n, mean=mean, m2=m2)


def welford_add_batch(state: Welford, xs: np.ndarray) -> Welford:
    """Fold a 1-D batch of samples into the running state."""
    xs = np.asarray(xs, np.float32).ravel()
    mean = np.float32(np.mean(xs, dtype=np.float32))
    m2 = np.float32(np.sum(np.square(xs - mean), dtype=np.float32))
    return welford_merge(state, Welford(count=np.float32(xs.size),
                                        mean=mean, m2=m2))


def welford_finalize(state: Welford) -> Dict[str, float]:
    """Population mean/std (ddof=0)."""
    var = state.m2 / max(state.count, np.float32(1.0))
    return {"count": float(state.count), "mean": float(state.mean),
            "std": float(np.sqrt(max(var, np.float32(0.0))))}


DEFAULT_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


@dataclasses.dataclass
class StreamingMoments:
    """Host-side accumulator for one scalar metric over the chip ensemble."""
    quantiles: Sequence[float] = DEFAULT_QUANTILES

    def __post_init__(self):
        self._state = welford_init()
        self._values: list = []

    def update(self, chunk_values) -> None:
        """Fold a [chunk_chips] vector of per-chip metric values."""
        vals = np.asarray(chunk_values, np.float32).ravel()
        self._state = welford_add_batch(self._state, vals)
        self._values.append(vals)

    @property
    def per_chip(self) -> np.ndarray:
        """All folded per-chip values, in arrival order."""
        return (np.concatenate(self._values) if self._values
                else np.zeros((0,), np.float32))

    @property
    def count(self) -> float:
        """Chips folded in so far."""
        return float(self._state.count)

    @property
    def mean_value(self) -> float:
        """Running population mean of the metric."""
        return float(self._state.mean)

    def stderr(self) -> float:
        """Standard error of the running mean (inf below 2 chips)."""
        n = self.count
        if n < 2:
            return float("inf")
        return welford_finalize(self._state)["std"] / math.sqrt(n)

    def summary(self) -> Dict[str, float]:
        """{count, mean, std (ddof=0), qXX...} over the folded chips."""
        out = welford_finalize(self._state)
        vals = self.per_chip
        if vals.size:
            qs = np.quantile(vals, np.asarray(self.quantiles, np.float64))
            out.update({f"q{int(round(q * 100)):02d}": float(v)
                        for q, v in zip(self.quantiles, qs)})
        return out
