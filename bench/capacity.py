"""The rate sweep that fixes a serving mix's offered load: one set-up,
then windows of open-loop Poisson arrivals at each rate in turn, printing
per rate the requests due, answered, refused and failed, the answers that
came after the window closed (a growing backlog), and the p50 and p95
latency from when each request was due.

    python3 bench/capacity.py --workload <serving cell> --seed 5 \
        --rates 3,4,5,6,7,8 --seconds 20

The highest rate that keeps the p95 near a wave time with no backlog is
the capacity; the mix's "rate" is set at about four fifths of it, and the
sweep is recorded in the mix's file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchkit import main as bench_main  # noqa: E402
from benchkit import registry  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("capacity: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(registry.ROOT / "src"))
    spec = registry.load_spec()
    parts = registry.find(spec, args.workload)
    driver = parts["driver"]
    ctx = bench_main.RunContext(
        seed=args.seed, seconds=args.seconds, trace=False,
        device=torch.device("cuda", 0), cell=parts["cell"],
        config_name=parts["config_name"], config=parts["config"],
        traffic=parts["traffic"])
    t0 = time.perf_counter()
    state = driver.setup(ctx)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        state["rate"] = rate
        res = driver.window(state, args.seconds)
        raw = res["raw"]
        walls = raw["wave_wall_s"]
        print(json.dumps({
            "rate": rate, "due": res["attempted"],
            "answered": raw["requests"], "refused": raw["refused"],
            "failed": res["failed"],
            "answered_after_close": raw["answered_after_close"],
            "p50_s": raw["p50_s"], "p95_s": res["metrics"]["serve_p95_s"],
            "late_p95_s": raw["late_p95_s"],
            "wave_ms": 1e3 * sum(walls) / max(len(walls), 1),
            "lanes_per_wave": sum(raw["wave_requests"])
            / max(len(walls), 1)}), flush=True)
    state["engine"].stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
