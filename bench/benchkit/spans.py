"""The program's spans of the traced window (`repro_torch.obs.spans`), for
the readers of the `program_span` metrics that read them.

The program records spans only while a profiler trace runs, so its span
buffer holds the traced window's.  The readers find them under
`ctx["trace"]["spans"]`; where the trace summary has no such list, the
first reader drains the program's buffer into it.  A run without a trace,
or a program without a span buffer, gives None.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def _drain() -> Optional[List[Dict[str, Any]]]:
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans.drain_spans()[0]


def window_spans(ctx: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    """Every span of the traced window, or None."""
    t = ctx["trace"]
    if t is None:
        return None
    if "spans" not in t:
        t["spans"] = _drain()
    return t["spans"]


def named(ctx: Dict[str, Any], name: str) -> List[Dict[str, Any]]:
    """The window's spans called `name` (none where there are no spans)."""
    return [s for s in window_spans(ctx) or () if s["name"] == name]


def seconds(span: Dict[str, Any]) -> float:
    """A span's length in seconds."""
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def device_ms(spans: List[Dict[str, Any]]) -> List[float]:
    """The `device_ms` of each span that carries one."""
    return [s["ids"]["device_ms"] for s in spans if "device_ms" in s["ids"]]
