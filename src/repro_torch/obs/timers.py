"""Phase timers that split the first lap (kernel build, first launches,
caches warming) from steady-state throughput."""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class _Lap:
    """Handle yielded by `PhaseTimer.lap()`: set `.items` inside the block
    when the work amount is only known after it ran."""

    def __init__(self, items: float):
        self.items = items


class PhaseTimer:
    """Accumulates laps of one phase; the first lap is the warm-up lap."""

    def __init__(self, phase: str, unit: str = "items"):
        self.phase = phase
        self.unit = unit
        self.compile_s = 0.0        # first-lap wall
        self.compile_items = 0.0
        self.steady_s = 0.0         # laps 2..n wall
        self.steady_items = 0.0
        self.laps = 0
        self.last_s = 0.0

    @contextlib.contextmanager
    def lap(self, items: float = 0.0):
        """Time one lap of the phase."""
        t0 = time.perf_counter()
        handle = _Lap(items)
        try:
            yield handle
        finally:
            dt = time.perf_counter() - t0
            self.last_s = dt
            if self.laps == 0:
                self.compile_s += dt
                self.compile_items += handle.items
            else:
                self.steady_s += dt
                self.steady_items += handle.items
            self.laps += 1

    @property
    def total_s(self) -> float:
        """Wall seconds over every lap."""
        return self.compile_s + self.steady_s

    @property
    def total_items(self) -> float:
        """Items over every lap."""
        return self.compile_items + self.steady_items

    def rate(self) -> float:
        """Steady-state `unit`/sec (laps after the first); single-lap phases
        fall back to the total."""
        if self.laps >= 2 and self.steady_items > 0:
            return self.steady_items / max(self.steady_s, 1e-9)
        return self.total_items / max(self.total_s, 1e-9)

    def summary(self) -> Dict[str, float]:
        """The phase's laps, times, items and rate as one dict."""
        return {
            "phase": self.phase,
            "laps": self.laps,
            "compile_s": self.compile_s,
            "steady_s": self.steady_s,
            "total_s": self.total_s,
            self.unit: self.total_items,
            f"{self.unit}_per_sec": self.rate(),
        }
