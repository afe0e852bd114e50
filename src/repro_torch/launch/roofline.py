"""Roofline analysis from the port's dry-run records (the reference's
`repro.launch.roofline`), priced for the NVIDIA H100.

Per (arch x shape) single-pod cell, per-device totals come from the two
COST PROBES (L1 and L1+1 layers), as in the reference:

    body   = probe(L1+1) - probe(L1)          (one more layer of the family)
    prefix = probe(L1) - body                  (embed/head/opt + dense prefix)
    total  = prefix + body * n_layers_of_the_family

The port's trace unrolls every loop (layers, microbatches, the RWKV time
steps), so a full-depth record counts every layer itself, and the probe
method reproduces its FLOPs exactly for a homogeneous arch; no analytic
RWKV term is added.  Byte counts are in the records' real dtypes (no
bfloat16 correction).

Terms against one H100 SXM (dense data-sheet peaks at 700 W):
    compute    = FLOPs_dev / 989e12        (bf16 tensor cores)
    memory     = bytes_dev / 3.35e12       (HBM3)
    collective = collective_bytes_dev / 50e9
The collective rate is the network's: NDR InfiniBand, 400 Gb/s = 50 GB/s
per GPU with one NIC per GPU in an 8-GPU node.  Every production mesh axis
spans nodes (model = 16 > 8 GPUs a node), so every collective is priced
at it.  MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference).

Caveats (the same for every cell, so comparisons hold):
  * the memory term counts every local op's output twice (eager PyTorch
    materializes each op; a fused kernel would not), so it is an upper
    bound;
  * train collective totals scale by the microbatch count (FSDP gathers
    re-run per microbatch) through the mb1/mb2 probe split.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--csv out.csv]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, per H100 SXM
HBM_BW = 3.35e12           # bytes/s per H100 SXM
NET_BW = 50e9              # bytes/s per GPU: NDR 400 Gb/s, one NIC a GPU

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

_COLL = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _load(path: Path) -> Optional[dict]:
    if not path.exists():
        return None
    rec = json.loads(path.read_text())
    return rec if rec.get("status") == "ok" else None


def _metrics(rec: dict) -> Dict[str, float]:
    ca = rec["cost_analysis"]
    out = {"flops": float(ca.get("flops", 0.0)),
           "bytes": float(rec.get("hbm_bytes_est")
                          or ca.get("bytes accessed", 0.0)),
           "bytes_raw": float(ca.get("bytes accessed", 0.0)),
           "coll": float(rec["collectives"]["total_bytes"]),
           "args": float(rec["memory_analysis"]["argument_size_in_bytes"])}
    for c in _COLL:
        out[f"coll_{c}"] = float(rec["collectives"][c]["bytes"])
    return out


def extrapolate(v1: float, v2: float, n_layers: int) -> float:
    """prefix + body * n from the L1 and L1+1 probes' values."""
    body = v2 - v1
    return max((v1 - body) + body * n_layers, 0.0)


def probe_totals(p1: dict, p2: dict, n_layers: int, kind: str, mb: int,
                 p1m: Optional[dict] = None,
                 p2m: Optional[dict] = None) -> tuple:
    """(totals by metric, method) from the probe records."""
    m1, m2 = _metrics(p1), _metrics(p2)
    totals = {k: extrapolate(m1[k], m2[k], n_layers) for k in m1}
    l1, l2 = p1["n_layers"], p2["n_layers"]
    if kind == "train" and p1m is not None and p2m is not None:
        # separate param collectives (x mb in production: FSDP gathers /
        # grad reductions per microbatch) from activation collectives
        # (total invariant to the microbatch split):
        #   coll(L, MB) = act(L) + MB * par(L)
        m1m, m2m = _metrics(p1m), _metrics(p2m)
        for k in list(totals):
            if not k.startswith("coll"):
                continue
            par1, par2 = m1m[k] - m1[k], m2m[k] - m2[k]
            act1, act2 = m1[k] - par1, m2[k] - par2
            totals[k] = (extrapolate(act1, act2, n_layers)
                         + mb * extrapolate(par1, par2, n_layers))
        return totals, f"probe-delta(L={l1},{l2};mb-split)"
    if kind == "train":
        for k in list(totals):
            if k.startswith("coll"):
                totals[k] *= mb
        return totals, f"probe-delta(L={l1},{l2};coll*mb UPPER BOUND)"
    return totals, f"probe-delta(L={l1},{l2})"


def analyze_cell(arch: str, shape: str, probe_suffixes=None,
                 out_dir: Path = OUT_DIR) -> Optional[dict]:
    from repro_torch.launch.dryrun import probe_pair

    main = _load(out_dir / f"{arch}__{shape}__single.json")
    if main is None:
        return None
    l1, l2 = probe_pair(arch) if probe_suffixes is None else probe_suffixes
    p1 = _load(out_dir / f"{arch}__{shape}__single__probe{l1}.json")
    p2 = _load(out_dir / f"{arch}__{shape}__single__probe{l2}.json")
    p1m = _load(out_dir / f"{arch}__{shape}__single__probe{l1}mb2.json")
    p2m = _load(out_dir / f"{arch}__{shape}__single__probe{l2}mb2.json")
    devices = main["devices"]
    kind = main["kind"]
    mb = main["microbatch"] or (max(1, main["global_batch"] // 32)
                                if kind == "train" else 1)

    if p1 is not None and p2 is not None:
        n_family = main["n_layers"] - main["n_dense_prefix"]
        totals, method = probe_totals(p1, p2, n_family, kind, mb, p1m, p2m)
    else:
        totals = _metrics(main)
        method = "full-depth record"

    tokens = main["global_batch"] * (main["seq_len"] if kind != "decode"
                                     else 1)
    n_active = main["active_param_count"]
    model_flops = (6.0 if kind == "train" else 2.0) * n_active * tokens
    model_flops_dev = model_flops / devices

    compute_s = totals["flops"] / PEAK_FLOPS
    memory_s = totals["bytes"] / HBM_BW
    coll_s = totals["coll"] / NET_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    model_time = model_flops_dev / PEAK_FLOPS
    return {
        "arch": arch, "shape": shape, "kind": kind, "devices": devices,
        "method": method,
        "flops_dev": totals["flops"], "bytes_dev": totals["bytes"],
        "coll_dev": totals["coll"],
        "coll_breakdown": {c: totals[f"coll_{c}"] for c in _COLL},
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": model_flops, "model_flops_dev": model_flops_dev,
        "useful_ratio": model_flops_dev / max(totals["flops"], 1.0),
        "roofline_fraction": model_time / max(bound_s, 1e-12),
        "args_dev": totals["args"],
        "memory_analysis": main.get("memory_analysis", {}),
    }


def fix_note(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_ratio"] < 0.5:
            return ("compute-bound with <50% useful FLOPs: cut remat "
                    "recompute (save attn outputs) or offload")
        return ("compute-bound near peak: increase arithmetic efficiency "
                "via fusion")
    if d == "memory":
        if row["kind"] == "decode":
            return ("memory-bound on KV/weight streaming: quantize cache, "
                    "grow batch, or fuse decode matmuls")
        return ("memory-bound: fuse elementwise chains, widen per-op tiles, "
                "avoid re-materialized activations")
    return ("collective-bound: overlap FSDP gathers with layer compute, "
            "reduce-scatter grads, or shrink TP degree")


def rows_table(rows) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | useful FLOP ratio | roofline frac | fix |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {fix_note(r)} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(OUT_DIR),
                    help="directory of the dry-run records")
    ap.add_argument("--csv", default=None,
                    help="CSV path (default <dir>/../roofline_torch.csv)")
    ap.add_argument("--markdown", default=None,
                    help="markdown path (default <dir>/../roofline_torch.md)")
    args = ap.parse_args(argv)
    out_dir = Path(args.dir)
    csv_path = Path(args.csv or out_dir.parent / "roofline_torch.csv")
    md_path = Path(args.markdown or out_dir.parent / "roofline_torch.md")

    from repro_torch.configs.registry import list_archs
    from repro_torch.configs.shapes import SHAPES

    rows = []
    for arch in list_archs():
        for shape in SHAPES:
            row = analyze_cell(arch, shape, out_dir=out_dir)
            if row:
                rows.append(row)

    import csv as _csv
    with open(csv_path, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["arch", "shape", "kind", "method", "flops_dev",
                    "bytes_dev", "coll_dev", "compute_s", "memory_s",
                    "collective_s", "dominant", "model_flops_dev",
                    "useful_ratio", "roofline_fraction"])
        for r in rows:
            w.writerow([r["arch"], r["shape"], r["kind"], r["method"],
                        f"{r['flops_dev']:.4g}", f"{r['bytes_dev']:.4g}",
                        f"{r['coll_dev']:.4g}", f"{r['compute_s']:.4g}",
                        f"{r['memory_s']:.4g}", f"{r['collective_s']:.4g}",
                        r["dominant"], f"{r['model_flops_dev']:.4g}",
                        f"{r['useful_ratio']:.3f}",
                        f"{r['roofline_fraction']:.3f}"])
    table = rows_table(rows)
    md_path.write_text(table)
    print(table, end="")
    print(f"\nwrote {csv_path} and {md_path} ({len(rows)} cells)")


if __name__ == "__main__":
    main()
