"""One run of one cell: set-up, the measured window, the metrics, the
check that decides `correct`, and the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A driver module (`bench/drivers/<name>.py`, named by the cell's mix)
supplies three functions:

    setup(ctx) -> state        inputs and weights from the seed, the
                               program's objects, every shape warmed
    window(state, seconds) -> dict
                               drives the program for `seconds`; returns
                               {"metrics": {end-to-end name: value},
                                "attempted", "failed", "raw": {...}}
    check(state, result) -> [(name, value, limit)]
                               after the window: the program's outputs
                               against the plain reference

`setup_s` runs from this module's entry to the window's start;
`peak_mem_gib` is `torch.cuda.max_memory_allocated()` over set-up and
window.  With `--trace 1` the window runs under the profiler and the
cell's per-layer metrics are read by `bench/metrics/<name>.py`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from benchkit import registry

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)
FLT_MAX = 1.7976931348623157e308


@dataclasses.dataclass
class RunContext:
    """What a driver's `setup` is given."""
    seed: int
    seconds: float
    trace: bool
    device: Any
    cell: Dict[str, Any]
    config_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]


def parse(argv: List[str]) -> argparse.Namespace:
    """The driver's command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs(root: Path) -> None:
    """Keep every build and kernel cache at fixed paths inside the
    checkout (the program builds its CUDA libraries under
    `build/repro_torch/` there by itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is in `FORBIDDEN`."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(torch, count: int) -> Dict[str, Any]:
    """The result's `device` record (peak memory filled in later)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def run_cell(spec: Dict[str, Any], parts: Dict[str, Any],
             args: argparse.Namespace, device, t_start: float
             ) -> Dict[str, Any]:
    """Set-up, window, metrics and check of one cell (`registry.find`'s
    parts) on `device`.  Returns the result record, the compared numbers
    under "checks" (no printing)."""
    import torch
    from benchkit.trace import Tracer

    ctx = RunContext(seed=int(args.seed) % (1 << 64), seconds=args.seconds,
                     trace=bool(args.trace), device=device,
                     cell=parts["cell"], config_name=parts["config_name"],
                     config=parts["config"], traffic=parts["traffic"])
    driver = parts["driver"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)       # the context and its allocator
        torch.cuda.reset_peak_memory_stats(device)
    t_ready = time.perf_counter()
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    # where set-up went: to the device's first tensor, then the driver's
    print(f"setup: {t_ready - t_start:.3f} s to the device, "
          f"{setup_s - (t_ready - t_start):.3f} s in the driver's set-up",
          file=sys.stderr)
    with Tracer(ctx.trace and cuda) as tracer:
        win = driver.window(state, args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics: Dict[str, Dict[str, Any]] = {}
    if not ctx.trace:
        values = dict(win["metrics"], setup_s=setup_s,
                      peak_mem_gib=peak / GIB)
        for m in registry.metrics_for(spec, "end_to_end", args.workload):
            if m["name"] not in values:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        rctx = {"cell": ctx.cell, "config": ctx.config,
                "traffic": ctx.traffic, "window": win["raw"],
                "trace": tracer.summary}
        for m in registry.metrics_for(spec, "per_layer", args.workload):
            value = registry.load_metric(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = driver.check(state, win)
    del state
    record: Dict[str, Any] = {
        "correct": all(v <= lim for _, v, lim in checks),  # NaN fails
        "attempted": int(win["attempted"]), "failed": int(win["failed"]),
        "metrics": metrics,
        "device": ({"platform": "cpu", "kind": "cpu", "count": 1}
                   if not cuda else device_info(torch, ctx.cell["chips"]))}
    record["device"]["memory_peak_bytes"] = int(peak)
    if tracer.summary is not None:
        s = tracer.summary
        record["device"]["busy_s"] = s["busy_s"]
        record["device"]["window_s"] = s["window_s"]
        record["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    # a number that is not finite (an output that never came) prints as
    # the largest float, so that the line stays JSON
    record["checks"] = {name: {"value": v if math.isfinite(v) else FLT_MAX,
                               "limit": lim}
                        for name, v, lim in checks}
    return record


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point: refuses without the cards the cell asks for or without
    the program beside the benchmark, prints the result as the last line
    of standard output and the compared numbers as the last lines of
    standard error."""
    t_start = time.perf_counter()
    args = parse(sys.argv[1:] if argv is None else argv)
    root = registry.ROOT
    spec = registry.load_spec(root)
    cell = registry.workload(spec, args.workload)
    set_cache_dirs(root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"bench: the program under test (src/repro_torch) is not in "
              f"{root}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    record = run_cell(spec, registry.find(spec, args.workload), args,
                      torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in record["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record))
    return 0
