"""CLI for the whole-detector chip-population Monte Carlo (Table II).

  python -m repro_torch.launch.mc --network detector --chips 16 \\
      --ablation table2

Random-init weights (from a seeded `torch.Generator`), the analytic device
model, per-chip mAP@0.5 on a synthetic IVS-geometry batch; every group conv
goes through the fused IRC MVM kernel on the card.  The geometry is
`yolo_irc.smoke()` (32x32 images), as in the JAX package's CLI.
`--device cpu` runs the plain PyTorch path on the CPU.  Layer-level sweeps, QAT (`--det-steps`), the
measured and aged device models, and run directories come in later slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path


def _ablation_columns(ablation: str, table):
    """--ablation -> named columns; the ideal column always runs."""
    if ablation == "table2":
        return list(table)
    by_name = dict(table)
    if ablation not in by_name:
        raise SystemExit(f"unknown ablation column: {ablation!r} "
                         f"(choices: table2, {', '.join(by_name)})")
    cols = [("ideal", by_name["ideal"])]
    if ablation != "ideal":
        cols.append((ablation, by_name[ablation]))
    return cols


def run_detector(args) -> dict:
    """Population mAP@0.5 per ablation column; prints a table, returns the
    report."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.kernels import ops
    from repro_torch.mc.detector_mc import run_mc_detector
    from repro_torch.mc.engine import McConfig, TABLE2_ABLATION
    from repro_torch.models.detector import IRCDetector
    from repro_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    cfg = yolo_irc.smoke()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides,
                                  n_classes=cfg.n_classes,
                                  n_anchors=cfg.n_anchors)
    params = det.init(torch.Generator().manual_seed(args.seed), device=dev)
    calib = data.batch_for_step(999, args.det_batch * 4)
    ev = data.batch_for_step(1000, args.det_batch)
    params = det.calibrate_bn(params, torch.from_numpy(calib.images).to(dev))
    images = torch.from_numpy(ev.images).to(dev)
    key = prng.PRNGKey(args.seed, device=dev)
    mc = McConfig(n_chips=args.chips, chunk_size=args.chunk)
    columns = _ablation_columns(args.ablation, TABLE2_ABLATION)

    print(f"# detector smoke {cfg.img_hw[0]}x{cfg.img_hw[1]} "
          f"batch={args.det_batch} chips={args.chips} chunk={args.chunk} "
          f"device={dev} pipeline={not args.no_pipeline}")
    print(f"{'config':14s} {'map50 mean±std':>16s} {'drop':>7s} "
          f"{'q05':>7s} {'q50':>7s} {'q95':>7s} {'chips':>5s} "
          f"{'chips/s':>8s} {'first_s':>8s}")
    results, report = {}, {"args": vars(args), "results": {}}
    ops.reset_launches()
    for name, cfg_ni in columns:
        results[name] = run_mc_detector(
            key, det, params, images, ev.boxes, ev.classes,
            mc=dataclasses.replace(mc, cfg=cfg_ni),
            pipeline=not args.no_pipeline)
    ideal = results["ideal"].metrics["map50"]["mean"]
    for name, res in results.items():
        m = res.metrics["map50"]
        print(f"{name:14s} {m['mean']:8.4f}±{m['std']:6.4f} "
              f"{ideal - m['mean']:7.4f} {m.get('q05', float('nan')):7.4f} "
              f"{m.get('q50', float('nan')):7.4f} "
              f"{m.get('q95', float('nan')):7.4f} {res.n_chips:5d} "
              f"{res.chips_per_sec:8.3f} {res.compile_s:8.2f}")
        report["results"][name] = {
            "metrics": m, "wall_s": res.wall_s,
            "chips_per_sec": res.chips_per_sec, "first_chunk_s": res.compile_s,
            "enqueue_s": res.enqueue_s, "device_s": res.device_s,
            "host_s": res.host_s,
            "per_chip_map50": res.per_chip["map50"].tolist()}
    report["kernel_launches"] = dict(ops.LAUNCHES)
    print(f"# kernel launches {json.dumps(ops.LAUNCHES)}")
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        print(f"# wrote {out}")
    return report


def main(argv=None) -> None:
    """Parse arguments and run the detector sweep."""
    ap = argparse.ArgumentParser(
        description="chip-ensemble Monte Carlo sweep (PyTorch/CUDA port)")
    ap.add_argument("--network", default="detector", choices=["detector"],
                    help="detector: whole-network mAP@0.5 population sweep "
                         "(the layer-level sweep comes in a later slice)")
    ap.add_argument("--det-batch", type=int, default=2,
                    help="detector eval batch size")
    ap.add_argument("--det-steps", type=int, default=0,
                    help="QAT steps before the sweep (only 0, random init, "
                         "in this slice)")
    ap.add_argument("--chips", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--ablation", default="all",
                    help="'table2' for the full effect sweep, or one column "
                         "name (ideal|devvar|devvar+nl|devvar+nl+peri|all)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serial chunk loop instead of the overlapped one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--json", default="", help="write the report here")
    args = ap.parse_args(argv)
    if args.det_steps:
        raise SystemExit("--det-steps > 0 needs QAT, which comes in a later "
                         "slice of the port")
    run_detector(args)


if __name__ == "__main__":
    main()
