"""Train an LM end to end with the port's stack (Trainer + AdamW +
checkpointing + restart) on the synthetic token pipeline: the twin of the
JAX package's `examples/train_lm.py`.

The default is a small model for a quick demonstration; `--size 100m`
builds a ~100M-parameter llama-style config; `--arch` trains an
architecture's smoke config instead.  `--irc` enables the paper's
technique: every projection is ternary-quantized through the STE (QAT), so
the trained model is crossbar-mappable.

  python -m repro_torch.examples.train_lm --steps 200           # on the card
  python -m repro_torch.examples.train_lm --arch hymba-1.5b --irc
  python -m repro_torch.examples.train_lm --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import prng
from repro_torch.configs.registry import get_config
from repro_torch.data.lm import SyntheticLMData
from repro_torch.models.common import scalar, tree_leaves_with_path
from repro_torch.models.lm_config import IRCMode, LMConfig
from repro_torch.models.transformer import LM
from repro_torch.runtime import resolve_device
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def size_config(size: str) -> LMConfig:
    if size == "100m":
        return LMConfig(name="lm-100m", n_layers=12, d_model=768, n_heads=12,
                        n_kv_heads=4, head_dim=64, d_ff=2048,
                        vocab_size=32768, dtype="float32",
                        param_dtype="float32")
    return LMConfig(name="lm-small", n_layers=4, d_model=256, n_heads=4,
                    n_kv_heads=2, head_dim=64, d_ff=688, vocab_size=4096,
                    dtype="float32", param_dtype="float32")


def main(argv=None) -> dict:
    """Train and print the JAX script's lines; return the `trainer`, its
    `history`, the config and its parameter count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--size", default="small", choices=["small", "100m"])
    ap.add_argument("--arch", default=None,
                    help="train an assigned arch's smoke config instead")
    ap.add_argument("--irc", action="store_true",
                    help="ternary-QAT every projection (the paper's mode)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = (get_config(args.arch, "smoke") if args.arch
           else size_config(args.size))
    if args.irc:
        cfg = dataclasses.replace(cfg, irc=IRCMode(enabled=True))
    lm = LM(cfg)
    n_params = sum(t.numel() for _, t in
                   tree_leaves_with_path(lm.abstract_params()))
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, irc={args.irc}")

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch)
    state = init_train_state(lm, prng.PRNGKey(0, device=dev), device=dev)
    lr = scalar(args.lr, torch.float32, dev)
    step_fn = make_train_step(lm, remat="none", lr_fn=lambda s: lr)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir,
                      log_every=max(args.steps // 20, 1)),
        step_fn, lambda s: data.batch_for_step(s, device=dev), state)
    del state
    hist = trainer.run()
    print(f"\nloss: first10={sum(h['loss'] for h in hist[:10])/10:.4f} "
          f"last10={sum(h['loss'] for h in hist[-10:])/10:.4f}")
    if trainer.straggler_steps:
        print(f"straggler steps detected: {trainer.straggler_steps[:10]}")
    return {"trainer": trainer, "history": hist, "cfg": cfg,
            "params": n_params}


if __name__ == "__main__":
    main()
