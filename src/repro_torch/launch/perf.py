"""Perf-iteration tool (the reference's `repro.launch.perf`): traces ONE
(arch x shape) cell's cost probes under a named variant of tuning knobs
and prints the roofline terms priced for the H100 (`launch.roofline`) —
the measure step of a hypothesis -> change -> measure loop.  Records go
to experiments/perf_torch/<arch>__<shape>__<variant>.json.

  python -m repro_torch.launch.perf --arch llama3-405b --shape decode_32k \\
      --variant baseline [--device cpu]
  python -m repro_torch.launch.perf --arch qwen3-moe-235b-a22b \\
      --shape train_4k --variant mb4 --microbatch 4
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

PERF_DIR = Path(__file__).resolve().parents[3] / "experiments" / "perf_torch"


def run_variant(arch: str, shape: str, variant: str, knobs: dict,
                device: str = "cuda") -> dict:
    """Trace the cell's probes (L1/L2, and mb2 for train) under `knobs`
    (remat, microbatch, attn_mode, act_overrides) and reconstruct the
    per-device totals and roofline terms."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import lower_cell, probe_pair, probe_points
    from repro_torch.launch.roofline import (HBM_BW, NET_BW, PEAK_FLOPS,
                                             probe_totals)

    cfg = get_config(arch, "full")
    l1, l2 = probe_pair(arch)
    probe_knobs = dict(knobs)
    mb_knob = probe_knobs.pop("microbatch", 0)
    kind = SHAPES[shape].kind
    recs = {}
    for pl, pmb in probe_points(kind, l1, l2):
        rec = lower_cell(arch, shape, "single", "full", probe_layers=pl,
                         microbatch=pmb, device=device, **probe_knobs)
        if rec["status"] != "ok":
            raise RuntimeError(f"probe L={pl} mb={pmb}: {rec}")
        recs[(pl, pmb)] = rec
    first = recs[(l1, 1)]
    mb_prod = mb_knob or (max(1, first["global_batch"] // 32)
                          if kind == "train" else 1)
    totals, method = probe_totals(
        recs[(l1, 1)], recs[(l2, 1)], cfg.n_layers - cfg.n_dense_prefix,
        kind, mb_prod, recs.get((l1, 2)), recs.get((l2, 2)))
    tokens = first["global_batch"] * (first["seq_len"] if kind != "decode"
                                      else 1)
    model_flops_dev = ((6.0 if kind == "train" else 2.0)
                       * cfg.active_param_count() * tokens
                       / first["devices"])
    terms = {"compute_s": totals["flops"] / PEAK_FLOPS,
             "memory_s": totals["bytes"] / HBM_BW,
             "collective_s": totals["coll"] / NET_BW}
    dominant = max(terms, key=terms.get)
    return {
        "arch": arch, "shape": shape, "variant": variant, "knobs": knobs,
        "method": method,
        "flops_dev": totals["flops"], "bytes_dev": totals["bytes"],
        "coll_dev": totals["coll"], **terms,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "model_flops_dev": model_flops_dev,
        "useful_ratio": model_flops_dev / max(totals["flops"], 1.0),
        "roofline_fraction": (model_flops_dev / PEAK_FLOPS)
        / max(terms[dominant], 1e-12),
        "coll_breakdown": {k[5:]: v for k, v in totals.items()
                           if k.startswith("coll_")},
        "memory_analysis_probe": recs[(l2, 1)].get("memory_analysis", {}),
        "args_dev": totals["args"], "lower_s": sum(
            r["lower_s"] for r in recs.values()),
        "probes": {f"L{pl}mb{pmb}": r for (pl, pmb), r in recs.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="block",
                    choices=["block", "dots", "names", "none"])
    ap.add_argument("--attn-mode", default=None,
                    choices=[None, "kv_heads", "q_groups", "kv_seq"])
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream (Megatron SP)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    knobs = {"remat": args.remat}
    if args.microbatch:
        knobs["microbatch"] = args.microbatch
    if args.attn_mode:
        knobs["attn_mode"] = args.attn_mode
    if args.sp:
        knobs["act_overrides"] = {"act_seq": ("model",)}
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    try:
        rec = run_variant(args.arch, args.shape, args.variant, knobs,
                          device=args.device)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape,
               "variant": args.variant, "status": "error",
               "traceback": traceback.format_exc()}
    out = PERF_DIR / f"{args.arch}__{args.shape}__{args.variant}.json"
    out.write_text(json.dumps(rec, indent=1))
    show = {k: rec.get(k) for k in ("variant", "compute_s", "memory_s",
                                    "collective_s", "dominant",
                                    "roofline_fraction", "useful_ratio")}
    print(json.dumps(show, indent=1))
    if "traceback" in rec:
        print(rec["traceback"][-1500:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
