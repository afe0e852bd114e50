"""Serving CLI: batched request serving for both network families on the
card (the reference's `repro.launch.serve`).

`--network lm` (the default) initialises a language model of the zoo
(`--arch`, `--variant smoke|full`; random weights from
`LM.init(PRNGKey(0))`, every normal leaf drawn by the threefry kernel),
restores `--ckpt-dir`'s latest checkpoint over them where one is given (a
params-only checkpoint, or a training one whose tree holds `params/...`;
either package's), and serves `--requests` prompts of 2-7 tokens drawn as
the reference draws them with the slot-wave `ServeEngine`: greedy, or
sampled at `--temperature` (the uniforms from the threefry kernel).
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
its alias `plain` the plain batched route.  A flag of the other network
exits with an error, as in the reference.

  python -m repro_torch.launch.serve --arch phi3-medium-14b --variant full \\
      --requests 8 --slots 4 --max-new 16 --run-dir experiments
  python -m repro_torch.launch.serve --network detector --requests 6 \\
      --slots 2 --committee 4 --run-dir experiments [--trace]

With `--run-dir` the run gets `<run-dir>/<run_id>/`: manifest.json (with
the card's name and power limit), metrics.jsonl with one `serve_wave`
event per wave and the phase (and, for the detector, latency) summaries,
and with `--trace` a `torch.profiler` trace in `trace/`.  Each run ends
with a `# kernel launches` line and, for the LM, a `# lm stats` JSON line
(tokens/s, first wave, peak device memory, the init's threefry launches).
`--device cpu` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.registry import all_archs
from repro_torch.launch.mc import DET_BACKENDS


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batched LM and detector serving (PyTorch/CUDA port)")
    ap.add_argument("--network", default="lm", choices=["lm", "detector"])
    # LM engine
    ap.add_argument("--arch", default="phi3-medium-14b", choices=all_archs())
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a checkpoint")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    # detector engine
    ap.add_argument("--det-scheme", default="ternary",
                    choices=["ternary", "binary"],
                    help="[detector] weight mapping scheme: proposed "
                         "ternary | baseline binary")
    ap.add_argument("--committee", type=int, default=4,
                    help="[detector] chips answering each request")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="[detector] admission-control queue bound")
    ap.add_argument("--det-backend", default="auto",
                    choices=list(DET_BACKENDS),
                    help="[detector] group-conv routing: auto (the "
                         "autotuner's table), "
                         "kernel (fused IRC MVM) or jnp / plain (batched "
                         "route)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="requests per wave at most")
    ap.add_argument("--seed", type=int, default=0,
                    help="root key of the LM's sampling / the request "
                         "committees")
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


def _check_flag_use(ap: argparse.ArgumentParser,
                    args: argparse.Namespace) -> None:
    """Fail fast on flags that silently do nothing for the chosen network."""
    lm_only = ["arch", "variant", "ckpt_dir", "max_new", "max_len",
               "temperature"]
    det_only = ["det_scheme", "committee", "max_queue", "det_backend"]
    misused = lm_only if args.network == "detector" else det_only
    for n in misused:
        if getattr(args, n) != ap.get_default(n):
            ap.error(f"--{n.replace('_', '-')} only applies to "
                     f"--network {'lm' if n in lm_only else 'detector'}")


def lm_prompts(n_requests: int, vocab_size: int, device) -> list:
    """The reference CLI's prompts: request i has 2 + i % 6 tokens, drawn
    by `randint(k, (n,), 0, vocab)` under a key split off PRNGKey(1)."""
    from repro_torch import prng
    rng = prng.PRNGKey(1, device=device)
    prompts = []
    for i in range(n_requests):
        rng, k = prng.split(rng)
        n = 2 + i % 6
        prompts.append([int(t) for t in
                        prng.randint(k, (n,), 0, vocab_size).cpu()])
    return prompts


def _logits_finite(lm, params, dev) -> bool:
    """Whether one decode step of token 0 on a fresh cache gives finite
    logits."""
    import torch
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    logits, _ = lm.decode_step(params, tok, lm.init_cache(1, 1, device=dev))
    return bool(torch.isfinite(logits).all())


def _serve_lm(args, obs) -> None:
    import torch
    from repro_torch import prng
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.transformer import LM
    from repro_torch.runtime import resolve_device
    from repro_torch.serve import ServeEngine

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(args.arch, args.variant)
    lm = LM(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    params = lm.init(prng.PRNGKey(0, device=dev), device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_launches = ops.LAUNCHES["threefry"]
    init_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        template = lm.abstract_params()
        try:  # params-only checkpoint
            restored, step = mgr.restore_latest(template, device=dev)
        except KeyError:  # training checkpoint: TrainState paths (params/...)
            restored, step = mgr.restore_latest({"params": template},
                                                device=dev)
            restored = restored["params"] if restored else None
        if restored is not None:
            params = restored
            print(f"restored step {step} from {args.ckpt_dir}")

    engine = ServeEngine(lm, params, batch_slots=args.slots,
                         max_len=args.max_len, seed=args.seed,
                         temperature=args.temperature, obs=obs)
    prompts = lm_prompts(args.requests, cfg.vocab_size, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    results = engine.generate(prompts, max_new_tokens=args.max_new)
    dt = time.time() - t0
    new = sum(len(r.tokens) for r in results)
    for i, r in enumerate(results[:4]):
        print(f"req {i}: {len(r.prompt)} prompt toks -> {r.tokens[:8]}...")
    st = engine.stats()
    decode, prefill = st["decode"], st["prefill"]
    print(f"{len(results)} requests, {new} new tokens, {dt:.1f}s "
          f"({new/dt:.1f} tok/s overall; "
          f"{decode['tokens_per_sec']:.1f} tok/s steady decode, "
          f"first wave {decode['compile_s']:.1f}s)")
    print(f"# kernel launches {json.dumps(ops.LAUNCHES)} by tail "
          f"{json.dumps(ops.TAIL_LAUNCHES)}")
    stats = {
        "arch": cfg.name,
        "params": sum(t.numel() for _, t in tree_leaves_with_path(params)),
        "param_dtype": cfg.param_dtype, "requests": len(results),
        "new_tokens": new, "wall_s": dt,
        "decode_tokens_per_sec": decode["tokens_per_sec"],
        "prefill_tokens_per_sec": prefill["tokens_per_sec"],
        "first_wave_s": prefill["compile_s"] + decode["compile_s"],
        "init_s": init_s, "init_threefry_launches": init_launches,
        "init_peak_gib": init_peak / 2**30,
        "serve_peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                           if on_card else 0.0),
        "in_vocab": all(0 <= t < cfg.vocab_size
                        for r in results for t in r.tokens),
        "logits_finite": _logits_finite(lm, params, dev),
        "tokens": [r.tokens for r in results]}
    print(f"# lm stats {json.dumps(stats)}")
    engine.log_stats()
    obs.finalize(status="ok", requests=len(results), new_tokens=new,
                 decode_tokens_per_sec=decode["tokens_per_sec"])


def main(argv=None) -> None:
    """Parse flags, open the run dir, route to the engine."""
    ap = _build_parser()
    args = ap.parse_args(argv)
    _check_flag_use(ap, args)

    from repro_torch.obs import maybe_runlog
    name = ("serve-detector" if args.network == "detector"
            else f"serve-{args.arch}")
    obs = maybe_runlog(bool(args.run_dir), name, args=vars(args),
                       root=args.run_dir, run_id=args.run_id or None)
    if obs.path is not None:
        print(f"# run dir: {obs.path}")
    if args.trace:
        obs.start_trace()
    if args.network == "detector":
        _serve_detector(args, obs)
    else:
        _serve_lm(args, obs)


if __name__ == "__main__":
    main()
