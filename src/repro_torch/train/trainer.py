"""The LM training loop with its fault-tolerance plumbing (the reference's
`repro.train.trainer`):

  * resume from the latest checkpoint (exact: the data pipeline is
    stateless-seeded, batch(step) a pure function of the step);
  * async keep-k checkpoints every `ckpt_every` steps through the port's
    `CheckpointManager` (the reference's on-disk format, so either
    package's trainer resumes the other's), and a final save when the last
    step has none;
  * a straggler watchdog: a step slower than `straggler_factor` x the
    median of the last 50 step times (once more than 5 are known) is
    recorded;
  * the metrics history, every metric a float plus `step` and
    `step_time_s`.

Each step is one `PhaseTimer("train_step")` lap that ends when the card
has finished it, so the first step's wall (kernel builds, allocator warm
up) is `compile_s`.  The old state is dropped as each step returns its
new one, as the reference donates it to its jitted step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, latest_step
from repro_torch.models.common import tree_leaves_with_path, tree_map
from repro_torch.obs import PhaseTimer, RunLog, as_runlog
from repro_torch.train.steps import TrainState


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


def _device(state: TrainState) -> torch.device:
    return next(t for _, t in tree_leaves_with_path(state)).device


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 batch_fn: Callable[[int], Dict],
                 state: TrainState, obs: Optional[RunLog] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.state = state
        self.history: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
                     if cfg.ckpt_dir else None)
        self.obs = as_runlog(obs)
        self.step_timer = PhaseTimer("train_step", unit="steps")

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint onto the state's device; the step
        to start from (0 without one)."""
        if self.ckpt is None:
            return 0
        template = tree_map(lambda t: torch.empty_like(t, device="meta"),
                            self.state)
        restored, step = self.ckpt.restore_latest(
            template, device=_device(self.state))
        if restored is None:
            return 0
        self.state = restored
        return int(step)

    def run(self) -> List[Dict[str, float]]:
        start = self.maybe_resume()
        step_times: List[float] = []
        for step in range(start, self.cfg.total_steps):
            batch = self.batch_fn(step)
            with self.step_timer.lap(items=1):
                self.state, metrics = self.train_step(self.state, batch)
                if metrics["loss"].is_cuda:
                    torch.cuda.synchronize(metrics["loss"].device)
            dt = self.step_timer.last_s
            step_times.append(dt)
            if len(step_times) > 5:
                med = float(np.median(step_times[-50:]))
                if dt > self.cfg.straggler_factor * med:
                    self.straggler_steps.append(step)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = step
            rec["step_time_s"] = dt
            self.history.append(rec)
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                print(f"step {step:5d} loss {rec['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
                self.obs.log_event("train_step", **rec)
            if self.ckpt and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(self.state, step + 1)
                self.obs.log_event("checkpoint", step=step + 1)
        self.step_timer.log_to(self.obs, stragglers=len(self.straggler_steps))
        if self.ckpt:
            self.ckpt.wait()
            if latest_step(self.ckpt.directory) != self.cfg.total_steps:
                self.ckpt.save(self.state, self.cfg.total_steps)
        return self.history
