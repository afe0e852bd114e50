"""LM training launcher on the card (the reference's
`repro.launch.train`): the LM zoo's `--arch` at `--variant smoke|full`,
`init_train_state` from PRNGKey(0) (every normal leaf drawn by the
threefry kernel), the synthetic token pipeline, `make_train_step` (AdamW at
a constant `--lr`, `--remat`, `--microbatch`, `--irc` for ternary QAT of
every projection) and the `Trainer`: resume from `--ckpt-dir`'s latest
checkpoint (either package's), async keep-3 saves every steps // 4 steps,
the straggler watchdog.

  python -m repro_torch.launch.train --arch hymba-1.5b --variant full \\
      --steps 8 --batch 8 --seq 4096 --microbatch 4 --remat block \\
      --ckpt-dir /path/to/ckpt --run-dir experiments

`--ckpt-dir ''` trains without checkpoints.  `--mesh host` is this one
device; `--mesh single|multi` (the reference's 256- and 512-chip
production meshes) exits with an error, as the reference does on a host
without those chips.  With `--run-dir` the run gets `<run-dir>/<run_id>/`
with the reference CLI's events (`train_step` every steps // 20 steps,
`checkpoint`, the `phase` summary) and, with `--trace`, a
`torch.profiler` trace in `trace/`.  Before its last line (the
reference's wording) the run prints a `# train stats` JSON line (params,
tokens a step, the losses, compile_s, steady steps/s and tokens/s, the
peak device memory) and the port's kernel launches (`# kernel launches`:
threefry at the init, `xla_fma` in the SSM scan).  `--device cpu` runs
the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.configs.registry import list_archs

PRODUCTION_MESH = {"single": 256, "multi": 512}


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LM training (PyTorch/CUDA port)")
    ap.add_argument("--arch", default="hymba-1.5b", choices=list_archs())
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "block", "dots", "names"])
    ap.add_argument("--irc", action="store_true",
                    help="ternary-QAT every projection (the paper's mode)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"),
        help="checkpoint directory ('' trains without checkpoints)")
    ap.add_argument("--weight-decay", type=float, default=1e-3)
    ap.add_argument("--run-dir", default="",
                    help="experiments/<run_id>/ run directory root "
                         "(manifest + metrics.jsonl; '' disables)")
    ap.add_argument("--run-id", default="")
    ap.add_argument("--trace", action="store_true",
                    help="capture a torch.profiler trace into the run dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    return ap


def check_mesh(kind: str) -> None:
    """`--mesh host` is this one device; the production meshes need
    devices no single host of the port has."""
    if kind in PRODUCTION_MESH:
        raise SystemExit(
            f"--mesh {kind}: the {PRODUCTION_MESH[kind]}-chip production "
            f"mesh needs {PRODUCTION_MESH[kind]} devices and this host has "
            f"one; use --mesh host")


def main(argv=None) -> None:
    ap = _build_parser()
    args = ap.parse_args(argv)

    from repro_torch.obs import maybe_runlog
    obs = maybe_runlog(bool(args.run_dir), f"train-{args.arch}",
                       args=vars(args), root=args.run_dir,
                       run_id=args.run_id or None)
    if obs.path is not None:
        print(f"# run dir: {obs.path}")
    if args.trace:
        obs.start_trace()

    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models.common import scalar, tree_leaves_with_path
    from repro_torch.models.lm_config import IRCMode
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import resolve_device
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    if args.irc:
        cfg = dataclasses.replace(cfg, irc=IRCMode(enabled=True))
    check_mesh(args.mesh)
    lm = LM(cfg)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()

    state = init_train_state(lm, prng.PRNGKey(0, device=dev), device=dev)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch)
    lr = scalar(args.lr, torch.float32, dev)
    step_fn = make_train_step(
        lm, opt_cfg=AdamWConfig(weight_decay=args.weight_decay),
        lr_fn=lambda s: lr, remat=args.remat, microbatch=args.microbatch)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir or None,
                      log_every=max(args.steps // 20, 1)),
        step_fn, lambda s: data.batch_for_step(s, device=dev), state,
        obs=obs)
    del state
    hist = trainer.run()
    timer = trainer.step_timer
    tokens = args.batch * args.seq
    stats = {
        "arch": cfg.name, "irc": args.irc, "remat": args.remat,
        "microbatch": args.microbatch,
        "params": sum(t.numel() for _, t in
                      tree_leaves_with_path(trainer.state.params)),
        "tokens_per_step": tokens, "resumed_at": hist[0]["step"],
        "steps": len(hist), "losses": [h["loss"] for h in hist],
        "step_times_s": [h["step_time_s"] for h in hist],
        "compile_s": timer.compile_s, "steps_per_sec": timer.rate(),
        "tokens_per_sec": timer.rate() * tokens,
        "stragglers": len(trainer.straggler_steps),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if on_card else 0.0)}
    print(f"# train stats {json.dumps(stats)}")
    print(f"# kernel launches {json.dumps(ops.LAUNCHES)} by tail "
          f"{json.dumps(ops.TAIL_LAUNCHES)}")
    print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps "
          f"(resumed at {hist[0]['step']}); "
          f"stragglers: {len(trainer.straggler_steps)}; "
          f"compile {timer.compile_s:.1f}s, "
          f"{timer.rate():.2f} steps/s steady")
    obs.finalize(status="ok", final_loss=hist[-1]["loss"],
                 steps=len(hist), steps_per_sec=timer.rate(),
                 compile_s=timer.compile_s)


if __name__ == "__main__":
    main()
