"""Run directories, phase timing and MC convergence telemetry, one format
for every entry point of the port (the MC CLI, the serving engine):

  RunLog / NullRunLog    `experiments/<run_id>/` writer: manifest.json
                         (args, git SHA, torch and CUDA versions, host,
                         backend, the card's name and power limit),
                         append-only metrics.jsonl, per-chip .npy arrays,
                         optional torch.profiler trace
  PhaseTimer / timed_step  first lap split from steady-state laps;
                         chips/s, requests/s
  LatencyTracker         exact submit-to-response latency percentiles
  ConvergenceMonitor     standard error of the mean per metric after each
                         MC chunk, and the optional `stderr_target` stop
  collect_env / git_sha  provenance helpers
  spans                  `span` / `close_span` / `count`: spans and
                         counters, on while a profiler trace runs;
                         `drain_spans` empties their buffer and
                         `trace_events` places the spans the profiler did
                         not record on the trace's clock
"""
from repro_torch.obs.runlog import (RunLog, NullRunLog, NULL_RUNLOG,
                                    as_runlog, collect_env, git_sha)
from repro_torch.obs.timers import (PhaseTimer, LatencyTracker, timed_step,
                                    maybe_runlog)
from repro_torch.obs.convergence import ConvergenceMonitor
from repro_torch.obs import spans

__all__ = ["RunLog", "NullRunLog", "NULL_RUNLOG", "as_runlog", "collect_env",
           "git_sha", "PhaseTimer", "LatencyTracker", "timed_step",
           "maybe_runlog", "ConvergenceMonitor", "spans"]
