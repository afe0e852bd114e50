"""Spans and counters: where the port's host time goes, on the same clock
as the profiler's device timeline.

A span is a named stretch of one thread's time.  It records its name, its
parent (the span open on the same thread when it opened, 0 for none), its
thread (`threading.get_native_id`), start and end as
`time.perf_counter_ns()`, its ids (request id, wave, call, chunk index,
`chip_lo`, chips, ...) and the counters that `count` attached to it.

Spans are on exactly while a `torch.profiler` trace runs: the process-wide
flag `torch.autograd.profiler._is_profiler_enabled`, which the profiler
sets when it starts and clears when it stops.  There is no other switch.
Off, `span` and `count` cost one read of that flag: no span object, no
clock read, no `record_function`.  On, a span on a thread that the
profiler records (the thread that started it) is also a `record_function`
range of the same name, so it lands in the timeline beside the kernels.
A thread started before the profiler (the detector service's scheduler) is
not recorded; its spans only reach the buffer, and `trace_events` places
them on the trace's clock afterwards.

Finished spans go into one bounded in-memory buffer; past `MAX_SPANS` they
are counted as dropped instead.  `drain_spans` empties it.  Nothing is
written while a trace runs.

A device-timed span (`device_span`) also records a timing event on the
device's current stream where it opens and where it closes; once the
device has passed both (after a wait of the caller's that covers them),
`settle_device_ms` sets its `device_ms`, with no wait of its own.
"""
from __future__ import annotations

import itertools
import statistics
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

#: finished spans the buffer holds between drains
MAX_SPANS = 1 << 18

_lock = threading.Lock()
_buffer: List["Span"] = []
_dropped = 0
_local = threading.local()
_next_id = itertools.count(1)
# device-timed spans whose `device_ms` is not set yet: (span, start, end)
_unsettled: List[Tuple["Span", Any, Any]] = []


def spans_on() -> bool:
    """Whether a profiler trace runs, so that spans are recorded."""
    return _profiler._is_profiler_enabled


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _thread() -> int:
    """This thread's native id, asked of the system once per thread: it is
    a system call, which costs tens of microseconds where system calls
    are intercepted."""
    tid = getattr(_local, "thread", None)
    if tid is None:
        tid = _local.thread = threading.get_native_id()
    return tid


def _keep(s: "Span") -> None:
    global _dropped
    with _lock:
        if len(_buffer) < MAX_SPANS:
            _buffer.append(s)
        else:
            _dropped += 1


class Span:
    """One open or finished span; `with` it to time the block."""

    __slots__ = ("name", "ident", "parent", "thread", "start_ns", "end_ns",
                 "ids", "counts", "recorded", "_rf")

    def __init__(self, name: str, ids: Dict[str, Any]):
        self.name = name
        self.ident = next(_next_id)
        self.parent = 0
        self.thread = _thread()
        self.start_ns = self.end_ns = 0
        self.ids = ids
        self.counts: Dict[str, int] = {}
        self.recorded = False
        self._rf = None

    def set(self, **fields) -> None:
        """Attach more ids or values (a chunk's `device_ms`) to the span."""
        self.ids.update(fields)

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].ident if stack else 0
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
            self.recorded = True
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False

    def as_dict(self) -> Dict[str, Any]:
        """The finished span as plain values; `recorded` says whether the
        profiler also holds it as a `record_function` range."""
        return {"name": self.name, "id": self.ident, "parent": self.parent,
                "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "ids": dict(self.ids),
                "counts": dict(self.counts),
                "recorded": self.recorded}


class _Off:
    """What `span` gives while no trace runs: does nothing."""

    __slots__ = ()

    def set(self, **fields) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _DeviceTimed(Span):
    """A span that also brackets its block with timing events on the
    device's current stream (`device_span`)."""

    __slots__ = ("_device", "_start_ev")

    def __init__(self, name: str, ids: Dict[str, Any],
                 device: torch.device):
        super().__init__(name, ids)
        self._device = device
        self._start_ev = None

    def __enter__(self) -> "Span":
        super().__enter__()
        self._start_ev = device_mark(self._device)
        return self

    def __exit__(self, *exc) -> bool:
        end = device_mark(self._device)
        if self._start_ev is not None and end is not None:
            with _lock:
                _unsettled.append((self, self._start_ev, end))
        self._start_ev = None
        return super().__exit__(*exc)


def device_span(name: str, device: torch.device, **ids):
    """A span named `name` with `ids` whose device time between its start
    and its end `settle_device_ms` sets as `device_ms` (CUDA devices);
    `OFF` while no trace runs, and while a CUDA graph is being captured
    (whose replays no span sees)."""
    if not _profiler._is_profiler_enabled or (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        return OFF
    return _DeviceTimed(name, ids, device)


def settle_device_ms() -> int:
    """Set `device_ms` on every device-timed span whose end event the
    device has passed (no wait here: the others stay for a later call);
    returns how many were set."""
    with _lock:
        todo = list(_unsettled)
        _unsettled.clear()
    left, done = [], 0
    for s, start, end in todo:
        if end.query():
            s.set(device_ms=start.elapsed_time(end))
            done += 1
        else:
            left.append((s, start, end))
    if left:
        with _lock:
            _unsettled.extend(left)
    return done


def span(name: str, **ids):
    """A span named `name` with `ids`, for a `with` block; `OFF` while no
    trace runs."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, ids)


def close_span(name: str, start_ns: int, **ids) -> None:
    """Record a span that began at `start_ns` (`perf_counter_ns`, e.g. a
    request's submit time) and ends now, as a child of the span open on
    this thread.  It is never a `record_function` range."""
    if not _profiler._is_profiler_enabled:
        return
    s = Span(name, ids)
    stack = _stack()
    s.parent = stack[-1].ident if stack else 0
    s.start_ns, s.end_ns = int(start_ns), time.perf_counter_ns()
    _keep(s)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the span open on this thread (nothing
    where none is open)."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + int(n)


def device_mark(device: torch.device):
    """While spans are on, a timing CUDA event recorded now on the current
    stream of `device`; None off or for a device other than CUDA."""
    if not _profiler._is_profiler_enabled or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def elapsed_ms(start, end) -> Optional[float]:
    """Device milliseconds between two timing events that have completed
    (no synchronisation here); None where either is missing."""
    if start is None or end is None:
        return None
    return start.elapsed_time(end)


def drain_spans() -> Tuple[List[Dict[str, Any]], int]:
    """Empty the buffer: (its finished spans as `Span.as_dict`, in the order
    they ended, and the number dropped past `MAX_SPANS` since the last
    drain)."""
    global _buffer, _dropped
    with _lock:
        kept, dropped = _buffer, _dropped
        _buffer, _dropped = [], 0
    return [s.as_dict() for s in kept], dropped


def trace_events(events: List[Dict[str, Any]], spans: List[Dict[str, Any]]
                 ) -> Tuple[List[Dict[str, Any]], Optional[float]]:
    """The spans of `spans` that the profiler did not record, as Chrome-trace
    `user_annotation` events on the clock of `events` (an exported trace's
    "traceEvents"), one `tid` per thread of the program.

    Every span recorded both ways (a `record_function` range in `events`
    and a span in `spans`: each name's ranges and spans paired in time
    order where their numbers agree) gives the offset from
    `perf_counter_ns` to the trace's `ts`; the median over them is used.
    Returns (events, offset in us), or ([], None) where no span was
    recorded both ways."""
    ranges: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges[e.get("name")].append(e)
    mine: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for s in spans:
        if s["recorded"]:
            mine[s["name"]].append(s)
    offsets, pid = [], None
    for name, recorded in mine.items():
        theirs = ranges.get(name, [])
        if len(theirs) != len(recorded):
            continue
        for s, e in zip(sorted(recorded, key=lambda s: s["start_ns"]),
                        sorted(theirs, key=lambda e: float(e["ts"]))):
            offsets.append(float(e["ts"]) - s["start_ns"] * 1e-3)
            pid = e.get("pid", pid)
    if not offsets:
        return [], None
    off = statistics.median(offsets)
    out = []
    for s in spans:
        if s["recorded"]:
            continue
        args = dict(s["ids"], **s["counts"])
        args.update(span_id=s["id"], span_parent=s["parent"])
        out.append({"ph": "X", "cat": "user_annotation", "name": s["name"],
                    "pid": pid, "tid": s["thread"],
                    "ts": s["start_ns"] * 1e-3 + off,
                    "dur": (s["end_ns"] - s["start_ns"]) * 1e-3,
                    "args": args})
    return out, off
