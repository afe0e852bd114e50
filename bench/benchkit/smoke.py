"""Smoke-sized cells for the CPU tests: every cell of `BENCHMARK.json`
with its configuration and mix cut to sizes a CPU runs in seconds (two
stages of a 32x64 detector, a 32-vector layer, chunks of two dies), the
parts `registry.find` gives, ready for `main.run_cell` or the control."""
from __future__ import annotations

from typing import Any, Dict

from benchkit import registry


def parts(spec: Dict[str, Any], cell: str) -> Dict[str, Any]:
    """`registry.find(spec, cell)` at smoke size."""
    p = registry.find(spec, cell)
    cfg, tr = p["config"], p["traffic"]
    if "fan_in" in cfg:
        cfg.update(batch=32)
        tr.update(chunk=8, chunks_per_call=2, sample_dies=8)
    else:
        cfg.update(img_hw=[32, 64], stage_channels=[60, 120],
                   blocks_per_stage=[1, 2], n_anchors=2, bias_rows=16)
        tr.update(images=2, chunk=2, chunks_per_call=2, sample_dies=2,
                  pool=4, calib=2, committee=2, slots=2, rate=20.0,
                  sample_requests=2)
    return p


def seconds(p: Dict[str, Any]) -> float:
    """A window that holds some work at smoke size: one call of a sweep,
    a few requests of a service."""
    return 0.75 if "rate" in p["traffic"] else 0.01
