"""Serving CLI: the population-aware detector service on the card.

`--network detector` builds the IRC detector at the smoke geometry
(`yolo_irc.smoke(--det-scheme)`), random weights from
`IRCDetector.init(PRNGKey(0))` with its stem BN calibrated, and serves
synthetic images through `DetectorServeEngine`'s background scheduler:
every request is answered by a committee of `--committee` sampled chips
with mean/std/quantile confidence, each group conv through the fused IRC
MVM kernel and every die draw through the threefry kernel on the card.
`--det-backend` routes each group conv as in `repro_torch.launch.mc`:
`auto` (default) as the autotuner's table for this card says (untuned:
the kernel), `kernel` the fused IRC MVM, `jnp` (the JAX CLI's name) or
its alias `plain` the plain batched route.
`--network lm` (the reference's default) names the LM serving engine,
which comes with a later slice of the port: it exits non-zero.

  python -m repro_torch.launch.serve --network detector --requests 6 \\
      --slots 2 --committee 4 --run-dir experiments [--trace]

With `--run-dir` the run gets `<run-dir>/<run_id>/`: manifest.json (with
the card's name and power limit), metrics.jsonl with one `serve_wave`
event per wave and the phase and latency summaries, and with `--trace` a
`torch.profiler` trace in `trace/`.  `--device cpu` runs the plain PyTorch
path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch.mc import DET_BACKENDS


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batched detector serving (PyTorch/CUDA port)")
    ap.add_argument("--network", default="lm", choices=["lm", "detector"])
    ap.add_argument("--det-scheme", default="ternary",
                    choices=["ternary", "binary"],
                    help="weight mapping scheme: proposed ternary | "
                         "baseline binary")
    ap.add_argument("--committee", type=int, default=4,
                    help="chips answering each request")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission-control queue bound")
    ap.add_argument("--det-backend", default="auto",
                    choices=list(DET_BACKENDS),
                    help="group-conv routing: auto (the autotuner's table), "
                         "kernel (fused IRC MVM) or jnp / plain (batched "
                         "route)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="requests per wave at most")
    ap.add_argument("--seed", type=int, default=0,
                    help="root key of the request committees")
    ap.add_argument("--run-dir", default="",
                    help="root of the <run_id>/ run directory (per-wave "
                         "telemetry; '' disables)")
    ap.add_argument("--run-id", default="")
    ap.add_argument("--trace", action="store_true",
                    help="capture a torch.profiler trace into the run dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    return ap


def _serve_detector(args, obs) -> None:
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.kernels import ops
    from repro_torch.models.detector import IRCDetector
    from repro_torch.runtime import resolve_device
    from repro_torch.serve import DetectorServeEngine

    dev = resolve_device(args.device)
    cfg = yolo_irc.smoke(args.det_scheme)
    det = IRCDetector(cfg)
    params = det.init(prng.PRNGKey(0, device=dev), device=dev)
    data = SyntheticDetectionData(cfg.img_hw, cfg.n_classes, cfg.n_anchors,
                                  cfg.strides, seed=1)
    calib = data.batch_for_step(0, max(args.requests, 2))
    params = det.calibrate_bn(params, torch.from_numpy(calib.images).to(dev))

    engine = DetectorServeEngine(
        det, params, committee=args.committee, batch_slots=args.slots,
        max_queue=args.max_queue, seed=args.seed,
        use_kernel=DET_BACKENDS[args.det_backend], obs=obs)
    images = calib.images
    ops.reset_launches()
    engine.start()
    try:
        t0 = time.time()
        rids = [engine.submit(images[i % images.shape[0]])
                for i in range(args.requests)]
        responses = [engine.result(rid, timeout=600) for rid in rids]
        dt = time.time() - t0
    finally:
        engine.stop()

    for r in responses[:4]:
        c = r.confidence
        print(f"req {r.request_id} (wave {r.wave}): "
              f"{len(r.detections)} boxes, confidence "
              f"{c['mean']:.3f}±{c['std']:.3f} "
              f"[q05={c.get('q05', 0.0):.3f}, q95={c.get('q95', 0.0):.3f}], "
              f"queue {r.queue_s*1e3:.0f}ms")
    stats = engine.stats()
    lat = stats["queue_latency"]
    print(f"{len(responses)} requests over {args.committee}-chip committees, "
          f"{dt:.1f}s ({len(responses)/dt:.2f} req/s overall; "
          f"{stats['wave']['requests_per_sec']:.2f} req/s steady, "
          f"first wave {stats['wave']['compile_s']:.1f}s; "
          f"queue p50={lat['p50']*1e3:.0f}ms p95={lat['p95']*1e3:.0f}ms)")
    print(f"# kernel launches {json.dumps(ops.LAUNCHES)}")
    engine.log_stats()
    obs.finalize(status="ok", requests=len(responses),
                 committee=args.committee,
                 requests_per_sec=stats["wave"]["requests_per_sec"],
                 queue_p50_s=lat["p50"], queue_p95_s=lat["p95"])


def main(argv=None) -> None:
    """Parse flags, open the run dir, and serve the detector."""
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.network == "lm":
        raise SystemExit("--network lm: the LM serving engine (ServeEngine "
                         "and the LM zoo) comes with a later slice of the "
                         "port; use --network detector")

    from repro_torch.obs import maybe_runlog
    obs = maybe_runlog(bool(args.run_dir), "serve-detector", args=vars(args),
                       root=args.run_dir, run_id=args.run_id or None)
    if obs.path is not None:
        print(f"# run dir: {obs.path}")
    if args.trace:
        obs.start_trace()
    _serve_detector(args, obs)


if __name__ == "__main__":
    main()
