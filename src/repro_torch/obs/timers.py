"""Phase timers that split the first lap (kernel build, first launches,
caches warming) from steady-state throughput, and the serving engine's
per-request latency percentiles.  While a profiler trace runs, each lap is
also a span named by its phase (`repro_torch.obs.spans`)."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

from repro_torch.obs import spans


class _Lap:
    """Handle yielded by `PhaseTimer.lap()`: set `.items` inside the block
    when the work amount is only known after it ran; `.span` is the lap's
    span (`spans.OFF` while no trace runs)."""

    def __init__(self, items: float, span):
        self.items = items
        self.span = span


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
    def lap(self, items: float = 0.0, **ids):
        """Time one lap of the phase; while a profiler trace runs the lap is
        also a span named by the phase, with `ids`."""
        t0 = time.perf_counter()
        sp = spans.span(self.phase, **ids)
        handle = _Lap(items, sp)
        if sp is not spans.OFF:
            sp.__enter__()
        try:
            yield handle
        finally:
            if sp is not spans.OFF:
                sp.__exit__(None, None, None)
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

    def log_to(self, runlog, **extra) -> None:
        """Emit a `phase` event through a RunLog (no-op on NullRunLog)."""
        runlog.log_event("phase", **self.summary(), **extra)


class LatencyTracker:
    """Per-item latency accumulator with exact percentile summaries: the
    serving engine records one submit-to-response latency per request."""

    def __init__(self):
        self._values: list = []

    def add(self, seconds: float) -> None:
        """Record one item's latency."""
        self._values.append(float(seconds))

    def summary(self) -> Dict[str, float]:
        """count/mean/p50/p95/p99 over everything recorded so far."""
        import numpy as np
        if not self._values:
            return {"count": 0.0}
        v = np.asarray(self._values, np.float64)
        return {"count": float(v.size), "mean": float(v.mean()),
                "p50": float(np.percentile(v, 50)),
                "p95": float(np.percentile(v, 95)),
                "p99": float(np.percentile(v, 99))}


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of every tensor in a nest of dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def timed_step(step_fn, timer: PhaseTimer, block_on=None):
    """Wrap a step so that every call is one timer lap (the first call is
    the warm-up lap).  The lap ends after `torch.cuda.synchronize` of each
    card that holds a tensor of the result (`block_on(result)` selects
    which part; default the whole result); on the CPU nothing blocks."""

    def wrapped(*args, **kwargs):
        with timer.lap(items=1):
            out = step_fn(*args, **kwargs)
            for dev in _cuda_devices(out if block_on is None
                                     else block_on(out), set()):
                torch.cuda.synchronize(dev)
        return out

    return wrapped


def maybe_runlog(enabled: bool, name: str, *, args=None,
                 root: str = "experiments", run_id: Optional[str] = None):
    """`RunLog.create` when enabled, else the no-op singleton: the CLIs'
    `--run-dir` pattern."""
    from repro_torch.obs.runlog import NULL_RUNLOG, RunLog
    if not enabled:
        return NULL_RUNLOG
    return RunLog.create(name, args=args, root=root, run_id=run_id)
