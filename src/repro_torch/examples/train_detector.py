"""End-to-end driver (the paper's task): train the IRC object detector with
QAT on synthetic IVS-geometry data, then evaluate the full structural
crossbar simulation under the paper's nonideal-effect ablation (Table II)
for BOTH designs:

  proposed : ternary 20/60/20, no BN, single-shot, extra bias
  baseline : binary + shared reference, in-memory BN, partial sums

The ablation runs as chip-population Monte Carlo (`run_ablation_detector`):
each column reports POPULATION mean±std mAP@0.5 over `--mc-chips` sampled
dies, and the per-chip metric vectors, the QAT step timing (first call vs
steady state) and the per-chunk convergence stream land in an
`experiments/<run_id>/` run directory (manifest.json + metrics.jsonl +
per-chip .npy; `--run-dir ''` disables, `--trace` adds a torch.profiler
trace).  The same flags, defaults, keys and run directory as the JAX
package's `examples/train_detector.py`, so both train the same weights
and sweep the same dies.

On the card the proposed design's group convs run the fused IRC MVM
kernel, the baseline's partial sums the plain batched route, and every die
draw the threefry kernel; `--det-backend` routes the sweeps as in
`repro_torch.launch.mc`.  Each design's kernel launches (QAT and sweep
apart) and, on the card, its peak device memory are printed.

Defaults are sized for a short run (32x32 images, 200 steps); pass
--full for the paper's 1024x576 geometry.

  python -m repro_torch.examples.train_detector --steps 200
  python -m repro_torch.examples.train_detector --device cpu --steps 3
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import prng
from repro_torch.configs import yolo_irc
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.data.detection import SyntheticDetectionData
from repro_torch.kernels import ops
from repro_torch.launch.mc import DET_BACKENDS
from repro_torch.mc.detector_mc import run_ablation_detector
from repro_torch.mc.engine import McConfig
from repro_torch.models.detector import IRCDetector
from repro_torch.obs import NULL_RUNLOG, PhaseTimer, maybe_runlog, timed_step
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import warmup_step_decay
from repro_torch.runtime import resolve_device
from repro_torch.train.det_qat import batch_tensors
from repro_torch.train.steps import ensemble_key_for_step, make_det_qat_step

ABLATION = [
    ("ideal", NonidealConfig.none()),
    ("dev-var", NonidealConfig(device_variation=True)),
    ("dev+nl", NonidealConfig(device_variation=True, nonlinearity=True)),
    ("dev+nl+sa", NonidealConfig(device_variation=True, nonlinearity=True,
                                 sa_variation=True, sensing_range=True)),
    ("all", NonidealConfig.all()),
]


def train(det, data, steps, batch, lr, seed=0, noise_cfg=NonidealConfig.none(),
          train_chips=1, resample_every=1, key=None, obs=NULL_RUNLOG,
          design="", device="cuda"):
    """QAT on the shared step builder (`train.steps.make_det_qat_step`),
    on `device` (the card unless the caller asks for the CPU).

    `train_chips=1` is the single-draw surrogate; >=2 trains against a
    chip population (ensemble-aware QAT).  `key` roots both the per-step
    noise stream and the chip-population stream (default PRNGKey(1)).
    Each step is one `qat_step` lap that ends after the card finished it,
    so the first call (the kernels' first launches) is split from the
    steady steps/s; both are logged through `obs`."""
    dev = resolve_device(device)
    params = det.init(prng.PRNGKey(seed, device=dev), device=dev)
    opt = adamw_init(params)
    timer = PhaseTimer("qat_step", unit="steps")
    step_fn = timed_step(make_det_qat_step(
        det, train_chips=train_chips, cfg_ni=noise_cfg,
        opt_cfg=AdamWConfig(weight_decay=1e-3)), timer)  # paper: AdamW 1e-3
    root = prng.PRNGKey(1, device=dev) if key is None else key

    for s in range(steps):
        images, targets = batch_tensors(data.batch_for_step(s, batch), dev)
        lr_s = warmup_step_decay(s, base_lr=lr,
                                 warmup_steps=max(steps // 10, 1),
                                 decay_points=((int(steps * 0.7), lr / 10),
                                               (int(steps * 0.9), lr / 100))
                                 ).to(dev)
        params, opt, loss = step_fn(params, opt, images, targets, lr_s,
                                    prng.fold_in(root, s),
                                    ensemble_key_for_step(root, s,
                                                          resample_every))
        if s % max(steps // 10, 1) == 0:
            print(f"  step {s:4d}  loss {float(loss):8.4f} "
                  f"({timer.total_s:5.1f}s)", flush=True)
            obs.log_event("train_step", design=design, step=s,
                          loss=float(loss), step_time_s=timer.last_s)
    timer.log_to(obs, design=design, train_chips=train_chips)
    print(f"  qat: first call {timer.compile_s:.1f}s, "
          f"{timer.rate():.2f} steps/s steady", flush=True)
    return params


class _Meter:
    """Kernel launches (`ops.LAUNCHES`) and, on the card, peak device
    memory over one block, read as differences so that a caller's own
    counts keep running."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.launches = {}
        self.peak_gib = None

    def __enter__(self):
        self._before = dict(ops.LAUNCHES)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.peak_gib = torch.cuda.max_memory_allocated(self.dev) / 2**30
        self.launches = {k: v - self._before.get(k, 0)
                         for k, v in ops.LAUNCHES.items()}
        return False


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="detector QAT + Table II population ablation "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--mc-chips", type=int, default=8,
                    help="chip-population size per ablation column")
    ap.add_argument("--mc-chunk", type=int, default=0,
                    help="MC chunk size (0 = whole population per chunk)")
    ap.add_argument("--stderr-target", type=float, default=None,
                    help="stop each MC column once the mAP standard error "
                         "reaches this target")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale 1024x576 geometry")
    ap.add_argument("--designs", default="proposed,baseline")
    ap.add_argument("--qat-noise", action="store_true",
                    help="variation-aware QAT: surrogate nonideal noise "
                         "during training (paper Sec. V)")
    ap.add_argument("--train-chips", type=int, default=1,
                    help="ensemble-aware QAT: chip realizations per step "
                         "(implies --qat-noise; 1 = single draw)")
    ap.add_argument("--resample-every", type=int, default=1,
                    help="QAT steps between chip-population resamples")
    ap.add_argument("--run-dir", default="experiments",
                    help="root for the experiments/<run_id>/ run directory "
                         "('' disables)")
    ap.add_argument("--run-id", default="")
    ap.add_argument("--trace", action="store_true",
                    help="capture a torch.profiler trace into the run dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--det-backend", default="auto",
                    choices=list(DET_BACKENDS),
                    help="the sweeps' group-conv routing, as in "
                         "repro_torch.launch.mc: auto (the autotuner's "
                         "table), kernel (fused IRC MVM), jnp / plain "
                         "(batched route)")
    return ap


def main(argv=None) -> dict:
    """Train and sweep each design; print the Table II and the drops.
    Returns the run's numbers: `results[design][column]` (mean, std) in
    percent, `per_chip[design][column]`, the drops, and per design its
    kernel launches and peak device memory (GiB; None on the CPU) for QAT
    and the sweep apart."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    obs = maybe_runlog(bool(args.run_dir), "train-detector",
                       args=vars(args), root=args.run_dir,
                       run_id=args.run_id or None)
    if obs.path is not None:
        print(f"# run dir: {obs.path}")
    if args.trace:
        obs.start_trace()

    noise_cfg = (NonidealConfig.all()
                 if (args.qat_noise or args.train_chips > 1)
                 else NonidealConfig.none())
    mc = McConfig(n_chips=args.mc_chips,
                  chunk_size=args.mc_chunk or args.mc_chips)
    results, per_chip, launches, peak_gib = {}, {}, {}, {}
    for design in args.designs.split(","):
        cfg = (yolo_irc.proposed() if design == "proposed"
               else yolo_irc.baseline()) if args.full else \
            yolo_irc.smoke("ternary" if design == "proposed" else "binary")
        det = IRCDetector(cfg)
        data = SyntheticDetectionData(img_hw=cfg.img_hw,
                                      stride=2 ** (len(cfg.stage_channels) + 1),
                                      n_classes=cfg.n_classes,
                                      n_anchors=cfg.n_anchors)
        print(f"\n=== {design} design: QAT ({args.steps} steps, "
              f"train_chips={args.train_chips}) ===")
        with _Meter(dev) as qat:
            params = train(det, data, args.steps, args.batch, args.lr,
                           noise_cfg=noise_cfg, train_chips=args.train_chips,
                           resample_every=args.resample_every, obs=obs,
                           design=design, device=dev)
        # deployment step (both designs): populate the digital stem's
        # running stats, with which eval mode normalizes, and for the
        # baseline the block BN stats that the in-memory BN fold maps into
        # bias cells
        calib = data.batch_for_step(999, args.batch * 4)
        params = det.calibrate_bn(params,
                                  torch.from_numpy(calib.images).to(dev))

        print(f"=== {design}: population MC ablation "
              f"({args.mc_chips} chips) ===")
        ev = data.batch_for_step(1000, args.batch * args.eval_batches)
        with _Meter(dev) as sweep:
            sweeps = run_ablation_detector(
                prng.PRNGKey(7000, device=dev), det, params,
                torch.from_numpy(ev.images).to(dev), ev.boxes, ev.classes,
                ablations=ABLATION, mc=mc, obs=obs,
                stderr_target=args.stderr_target,
                use_kernel=DET_BACKENDS[args.det_backend])
        results[design], per_chip[design] = {}, {}
        for name, res in sweeps.items():
            m = res.metrics["map50"]
            results[design][name] = (m["mean"] * 100, m["std"] * 100)
            per_chip[design][name] = res.per_chip["map50"]
            obs.save_array(f"per_chip_map50_{design}_{name}",
                           res.per_chip["map50"])
            print(f"  {name:10s} mAP {m['mean'] * 100:5.1f} "
                  f"± {m['std'] * 100:4.1f}  "
                  f"({res.n_chips} chips, {res.chips_per_sec:.2f} chips/s "
                  f"steady, first chunk {res.compile_s:.1f}s)")
        launches[design] = {"qat": qat.launches, "sweep": sweep.launches}
        peak_gib[design] = {"qat": qat.peak_gib, "sweep": sweep.peak_gib}
        print(f"# {design} kernel launches: qat {_nonzero(qat.launches)}; "
              f"sweep {_nonzero(sweep.launches)}")
        if dev.type == "cuda":
            print(f"# {design} peak device memory: qat {qat.peak_gib:.2f} "
                  f"GiB, sweep {sweep.peak_gib:.2f} GiB")

    print("\n=== Table II (synthetic-data analog, population mean) ===")
    header = "design     " + "".join(f"{n:>12s}" for n, _ in ABLATION)
    print(header)
    for design, r in results.items():
        row = f"{design:10s}" + "".join(f"{r[n][0]:12.1f}" for n, _ in ABLATION)
        print(row)
    summary = {}
    if {"proposed", "baseline"} <= results.keys():
        drop_p = results["proposed"]["ideal"][0] - results["proposed"]["all"][0]
        drop_b = results["baseline"]["ideal"][0] - results["baseline"]["all"][0]
        summary = {"drop_proposed": drop_p, "drop_baseline": drop_b}
        print(f"\nmAP drop under all effects: proposed {drop_p:.1f}, "
              f"baseline {drop_b:.1f} (paper: 3.85 vs catastrophic)")
    obs.finalize(status="ok", **summary)
    return {"results": results, "per_chip": per_chip, "summary": summary,
            "launches": launches, "peak_gib": peak_gib, "run_dir": obs.path}


if __name__ == "__main__":
    main()
