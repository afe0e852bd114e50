"""MC convergence telemetry: the standard error of the mean, streamed per
chunk.

The paper's claim is statistical (population mAP mean±std over sampled
chips), so the quality of the evidence is the standard error of that mean,
std/sqrt(n_chips), not the chip count alone.  `ConvergenceMonitor` sits on
the sweep's Welford accumulators, emits a `convergence` event after every
chunk (running count/mean/stderr per metric), and says whether an optional
`stderr_target` has been reached, so `run_mc`/`run_mc_detector` can stop
early: chips are keyed by id, so an early-stopped run is bit-identical to
the same-length prefix of the full run.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.runlog import NULL_RUNLOG, RunLog


class ConvergenceMonitor:
    """Streams per-metric stderr from `StreamingMoments` accumulators.

    `moments` is the sweep's name -> StreamingMoments dict (duck-typed on
    `.count`/`.mean_value`/`.stderr()`); `stderr_metric` narrows the
    early-stop criterion to one metric (default: every tracked metric must
    reach the target).  With `stderr_target=None` the monitor only logs.
    """

    def __init__(self, moments: Dict[str, object], *,
                 stderr_target: Optional[float] = None,
                 stderr_metric: Optional[str] = None,
                 runlog: RunLog = NULL_RUNLOG, phase: str = "mc"):
        if stderr_metric is not None and stderr_metric not in moments:
            raise ValueError(f"stderr_metric {stderr_metric!r} is not a "
                             f"tracked metric (have: {sorted(moments)})")
        self.moments = moments
        self.stderr_target = stderr_target
        self.stderr_metric = stderr_metric
        self.runlog = runlog
        self.phase = phase

    def _gated(self) -> Dict[str, object]:
        if self.stderr_metric is None:
            return self.moments
        return {self.stderr_metric: self.moments[self.stderr_metric]}

    def converged(self) -> bool:
        """True iff a target is set and every gated metric's stderr (which
        needs >= 2 chips to be defined) is at or under it."""
        if self.stderr_target is None:
            return False
        return all(m.stderr() <= self.stderr_target
                   for m in self._gated().values())

    def after_chunk(self, chunk: int, chips_done: int) -> bool:
        """Log the running stats; return True when early stop should fire."""
        self.runlog.log_event(
            "convergence", phase=self.phase, chunk=chunk, chips=chips_done,
            stderr_target=self.stderr_target,
            metrics={name: {"count": m.count, "mean": m.mean_value,
                            "stderr": m.stderr()}
                     for name, m in self.moments.items()})
        return self.converged()
