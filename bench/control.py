"""The control of the check that decides `correct`: the plain reference,
computed at the precision below the configuration's (TF32 for float32
with TF32 off: both operands of every matrix product rounded to 10
mantissa bits), put in the program's place for the outputs a run's check
samples, and judged by the same numbers against the reference at the
configuration's precision.  A sound check reads the control as not
correct.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        [--precision tf32]

Prints one JSON line per seed: the compared numbers, each beside its
limit.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchkit import main as bench_main  # noqa: E402
from benchkit import registry  # noqa: E402


def run_control(parts: Dict[str, Any], seeds: List[int], precision: str,
                device) -> List[Dict[str, Any]]:
    """The compared numbers of the control on each seed."""
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = bench_main.RunContext(
            seed=seed % (1 << 64), seconds=0.0, trace=False, device=device,
            cell=parts["cell"], config_name=parts["config_name"],
            config=parts["config"], traffic=parts["traffic"])
        driver = parts["driver"]
        state = driver.make_inputs(ctx)
        result = driver.control(state, precision)
        checks = driver.check(state, result)
        out.append({"seed": seed, "precision": precision,
                    "seconds": time.perf_counter() - t0,
                    "checks": {n: {"value": v, "limit": lim}
                               for n, v, lim in checks},
                    "correct": all(v <= lim for _, v, lim in checks)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--precision", default="tf32")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = registry.load_spec()
    parts = registry.find(spec, args.workload)
    for rec in run_control(parts, [int(s) for s in args.seeds.split(",")],
                           args.precision, torch.device("cuda", 0)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
