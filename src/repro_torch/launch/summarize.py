"""Summarize the port's dry-run records into a table (the reference's
`repro.launch.summarize`): per device, argument and temp GB, collective GB
and the collective kinds.

  PYTHONPATH=src python -m repro_torch.launch.summarize [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import COLLECTIVES, OUT_DIR


def rows_of(out_dir: Path):
    rows = []
    for p in sorted(out_dir.glob("*.json")):
        if "probe" in p.name:
            continue
        r = json.loads(p.read_text())
        if r.get("status") == "skipped":
            rows.append((r["arch"], r["shape"], r["mesh"], "SKIP", "", "",
                         "", ""))
            continue
        if r.get("status") != "ok":
            rows.append((r["arch"], r["shape"], r["mesh"], "ERROR", "", "",
                         "", ""))
            continue
        ma = r.get("memory_analysis", {})
        args_gb = ma.get("argument_size_in_bytes", 0) / 1e9
        temp_gb = ma.get("temp_size_in_bytes", 0) / 1e9
        coll = r["collectives"]
        coll_gb = coll["total_bytes"] / 1e9
        kinds = "+".join(k[:2] for k in COLLECTIVES if coll[k]["count"])
        rows.append((r["arch"], r["shape"], r["mesh"], "ok",
                     f"{args_gb:.2f}", f"{temp_gb:.2f}", f"{coll_gb:.2f}",
                     kinds))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(OUT_DIR),
                    help="directory of the dry-run records")
    args = ap.parse_args(argv)
    rows = rows_of(Path(args.dir))
    print("| arch | shape | mesh | status | args GB/dev | temp GB/dev | "
          "collective GB/dev | collective kinds |")
    print("|---|---|---|---|---|---|---|---|")
    for row in rows:
        print("| " + " | ".join(str(c) for c in row) + " |")
    n_ok = sum(1 for r in rows if r[3] == "ok")
    n_skip = sum(1 for r in rows if r[3] == "SKIP")
    n_err = sum(1 for r in rows if r[3] == "ERROR")
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_err} errors")


if __name__ == "__main__":
    main()
