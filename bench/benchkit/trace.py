"""The traced run's profiler window and its reduction to numbers.

`Tracer` wraps the measured window in `torch.profiler` (CPU and CUDA
activities), exports the timeline as a Chrome trace into a temporary file
under `TMPDIR`, reads it back and deletes it.  `reduce_events` turns the
timeline into what the per-layer readers take: device busy seconds (the
union of kernel, copy and set intervals), device time and count by kernel
name, the longest idle gaps labelled by what the host was doing, and the
window's length.  The same by-name sums `chip_smoke.py::profile_breakdown`
printed from `key_averages()`, here from the timeline so that busy time
and gaps come from one source.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host categories that say what the host was doing during a gap
HOST_CATS = ("cpu_op", "user_annotation")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


#: gaps labelled one by one; the rest are summed under one label
LABELLED_GAPS = 2000
#: host events looked at backwards from a gap for the op covering it
_LOOKBACK = 4000


def _host_label(host: List[Tuple[float, float, str]], starts: List[float],
                t: float) -> str:
    """The host op covering time t that started last (the innermost, where
    ops nest), or a plain label."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _LOOKBACK, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host outside any traced op"


def reduce_events(events: List[Dict[str, Any]], t_lo_us: float,
                  t_hi_us: float, top: int = 10) -> Dict[str, Any]:
    """Numbers of one traced window [t_lo_us, t_hi_us] (trace clock, us).

    Returns {"window_s", "busy_s", "kernels": {name: [count, seconds]},
    "launches", "device_ops": [[name, s]] (top by time), "idle_gaps":
    [[host label, s]] (gap seconds summed by label, top by time)}."""
    dev: List[Tuple[float, float]] = []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        lo, hi = max(ts, t_lo_us), min(ts + dur, t_hi_us)
        if hi <= lo:
            continue
        if cat in DEVICE_CATS:
            dev.append((lo, hi))
            if cat == "kernel":
                k = kernels[e.get("name", "?")]
                k[0] += 1
                k[1] += (hi - lo) * 1e-6
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?")))
    host.sort()
    busy = _merge(dev)
    busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
    starts = [h[0] for h in host]
    edges = [t_lo_us] + [x for iv in busy for x in iv] + [t_hi_us]
    spans = sorted(((hi - lo, lo) for lo, hi in zip(edges[0::2], edges[1::2])
                    if hi > lo), reverse=True)
    gaps: Dict[str, float] = defaultdict(float)
    for k, (length, lo) in enumerate(spans):
        label = (_host_label(host, starts, lo + 0.5 * length)
                 if k < LABELLED_GAPS else "shorter gaps")
        gaps[label] += length * 1e-6
    ops = sorted(((n, v[1]) for n, v in kernels.items()),
                 key=lambda p: -p[1])[:top]
    return {"window_s": (t_hi_us - t_lo_us) * 1e-6, "busy_s": busy_s,
            "kernels": {n: list(v) for n, v in kernels.items()},
            "launches": int(sum(v[0] for v in kernels.values())),
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in
                          sorted(gaps.items(), key=lambda p: -p[1])[:top]]}


def kernel_seconds(summary: Dict[str, Any], *patterns: str
                   ) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds any of
    `patterns`."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if any(p in name for p in patterns):
            n += count
            s += secs
    return n, s


class Tracer:
    """Profiles the block it wraps when `enabled`; `summary` then holds
    `reduce_events` of the block's window (None when disabled or when the
    profiler recorded no device work)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[Dict[str, Any]] = None
        self._prof = None

    def __enter__(self) -> "Tracer":
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark("bench.window_start")
        return self

    def _mark(self, name: str) -> None:
        from torch.autograd.profiler import record_function
        with record_function(name):
            time.sleep(0)

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        import torch
        torch.cuda.synchronize()
        self._mark("bench.window_end")
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        marks = {e["name"]: float(e["ts"]) for e in events
                 if e.get("name") in ("bench.window_start",
                                      "bench.window_end")}
        lo = marks.get("bench.window_start")
        hi = marks.get("bench.window_end")
        if lo is None or hi is None:
            raise RuntimeError("the trace lost the window's marks")
        summary = reduce_events(events, lo, hi)
        self.summary = summary if summary["busy_s"] > 0 else None
