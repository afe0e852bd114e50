"""Run directories: a manifest, an append-only metric event stream and the
run's arrays, the one telemetry format of the port's entry points (the MC
CLI, the serving engine).  A run is a directory:

  experiments/<run_id>/
    manifest.json     provenance: argv/args, git SHA, torch and CUDA
                      versions, host, backend, device count, the card's
                      name and power limit, timestamps
    metrics.jsonl     append-only event stream; one JSON object per line,
                      each with a monotonic `t` (seconds since run start)
                      and a `kind` ("chunk", "convergence", "phase", ...)
    *.npy             arrays persisted via `save_array` (per-chip metric
                      vectors from `McResult.per_chip`)
    trace/            optional `torch.profiler` trace (`--trace`), Chrome
                      trace JSON, with the spans of threads the profiler
                      does not record (the service's scheduler) placed on
                      its clock (`repro_torch.obs.spans.trace_events`)

`metrics.jsonl` is the run's evidence, not only its log: chunk events carry
the raw float32 per-chip metric values, so replaying the stream through
fresh `StreamingMoments` reproduces the reported population mean±std bit
for bit.

`NullRunLog` (singleton `NULL_RUNLOG`, via `as_runlog(None)`) is the no-op
twin, so library code instruments unconditionally and pays nothing when no
run directory was requested.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.obs import spans


def git_sha() -> Optional[str]:
    """HEAD SHA of the source tree this module runs from (None outside git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def _card() -> Dict[str, Optional[str]]:
    """The first card's name and power limit as `nvidia-smi` reports them;
    None for both when it is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return {"gpu_name": None, "gpu_power_limit": None}
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    name, _, limit = (lines[0] if lines else "").rpartition(",")
    if not name:
        return {"gpu_name": None, "gpu_power_limit": None}
    return {"gpu_name": name.strip(), "gpu_power_limit": limit.strip()}


def collect_env() -> Dict[str, Any]:
    """Host and toolchain metadata: what makes a run's numbers
    interpretable on another machine."""
    import platform
    import socket
    info: Dict[str, Any] = {
        "host": socket.gethostname(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "device_count": torch.cuda.device_count(),
    }
    if torch.cuda.is_available():
        info.update(_card())
    return info


def _jsonable(v):
    """torch tensors, numpy scalars and arrays -> plain Python for
    json.dumps (float32 values become the Python floats that equal them,
    so they round-trip exactly)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, bool, float)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class RunLog:
    """Writer for one `experiments/<run_id>/` run directory."""

    def __init__(self, run_dir: Path, manifest: Dict[str, Any]):
        self.path = Path(run_dir)
        self.path.mkdir(parents=True, exist_ok=True)
        self.manifest = manifest
        self._t0 = time.perf_counter()
        self._events = self.path / "metrics.jsonl"
        self._tracing = False
        self._prof = None
        self._write_manifest()

    @classmethod
    def create(cls, name: str, *, args: Optional[Dict[str, Any]] = None,
               root: str = "experiments",
               run_id: Optional[str] = None) -> "RunLog":
        """Create `root/<run_id>/` and write its manifest.  `run_id`
        defaults to `<utc-timestamp>-<name>-<6 hex>`: sortable, and unique
        across concurrent runs on one host."""
        run_id = run_id or (time.strftime("%Y%m%d-%H%M%S", time.gmtime())
                            + f"-{name}-{uuid.uuid4().hex[:6]}")
        manifest = {
            "run_id": run_id,
            "name": name,
            "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "argv": list(sys.argv),
            "args": _jsonable(args) if args is not None else None,
            "git_sha": git_sha(),
            "env": collect_env(),
            "status": "running",
        }
        return cls(Path(root) / run_id, manifest)

    def _write_manifest(self) -> None:
        (self.path / "manifest.json").write_text(
            json.dumps(self.manifest, indent=1, default=_jsonable))

    def log_event(self, kind: str, **fields) -> None:
        """Append one event line to metrics.jsonl."""
        ev = {"t": round(time.perf_counter() - self._t0, 6), "kind": kind}
        ev.update({k: _jsonable(v) for k, v in fields.items()})
        with self._events.open("a") as f:
            f.write(json.dumps(ev) + "\n")

    def save_array(self, name: str, arr) -> Path:
        """Persist an array as `<name>.npy` under the run dir."""
        import numpy as np
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        out = self.path / f"{name}.npy"
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, np.asarray(arr))
        return out

    def save_result(self, label: str, metrics: Dict[str, Dict[str, float]],
                    per_chip: Optional[Dict[str, Any]] = None,
                    **fields) -> None:
        """One sweep's summary event, and its per-chip metric vectors as
        .npy."""
        self.log_event("result", label=label, metrics=metrics, **fields)
        for name, vec in (per_chip or {}).items():
            self.save_array(f"per_chip_{name}_{label}", vec)

    def write_text(self, name: str, text: str) -> Path:
        """Write a text file (a CSV, a report) into the run dir."""
        out = self.path / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
        return out

    def start_trace(self) -> bool:
        """Start a `torch.profiler` trace (CPU, and CUDA on a card) that
        `stop_trace` writes into `<run_dir>/trace/`.  Returns False, and
        logs a `trace_error` event, when the profiler cannot start."""
        try:
            from torch.profiler import ProfilerActivity, profile
            spans.drain_spans()             # left by an earlier trace
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._tracing = True
        except Exception as e:
            self.log_event("trace_error", error=f"{type(e).__name__}: {e}")
            self._prof, self._tracing = None, False
        return self._tracing

    def stop_trace(self) -> None:
        """Stop the trace and export it as `trace/trace.json`, with the
        program's spans that the profiler did not record added on the
        trace's clock; a failed export, or such spans with no span to
        place them by, logs a `trace_error` event."""
        if not self._tracing:
            return
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            (self.path / "trace").mkdir(exist_ok=True)
            out = self.path / "trace" / "trace.json"
            self._prof.export_chrome_trace(str(out))
            self._add_spans(out)
        except Exception as e:
            self.log_event("trace_error", error=f"{type(e).__name__}: {e}")
        self._prof, self._tracing = None, False

    def _add_spans(self, path: Path) -> None:
        """Drain the span buffer into the exported trace at `path`."""
        found, dropped = spans.drain_spans()
        if dropped:
            self.log_event("trace_error", error=f"{dropped} spans dropped "
                           f"past the buffer's {spans.MAX_SPANS}")
        if all(s["recorded"] for s in found):
            return
        trace = json.loads(path.read_text())
        extra, offset = spans.trace_events(trace["traceEvents"], found)
        if offset is None:
            self.log_event("trace_error", error="no span recorded both by "
                           "the profiler and the program: the unrecorded "
                           "spans are left out of the trace")
            return
        trace["traceEvents"].extend(extra)
        path.write_text(json.dumps(trace))

    def finalize(self, status: str = "ok", **summary) -> None:
        """Stop any trace; record the status, the wall time and a summary
        in the manifest."""
        self.stop_trace()
        self.manifest["status"] = status
        self.manifest["wall_s"] = round(time.perf_counter() - self._t0, 6)
        if summary:
            self.manifest["summary"] = _jsonable(summary)
        self._write_manifest()


class NullRunLog(RunLog):
    """No-op RunLog: library code logs unconditionally; callers that asked
    for no run directory pay nothing and write nothing."""

    def __init__(self):          # noqa: super().__init__ deliberately skipped
        self.path = None
        self.manifest = {}
        self._tracing = False
        self._prof = None

    def log_event(self, kind: str, **fields) -> None:
        pass

    def save_array(self, name: str, arr):
        return None

    def save_result(self, label, metrics, per_chip=None, **fields) -> None:
        pass

    def write_text(self, name: str, text: str):
        return None

    def start_trace(self) -> bool:
        return False

    def stop_trace(self) -> None:
        pass

    def finalize(self, status: str = "ok", **summary) -> None:
        pass


NULL_RUNLOG = NullRunLog()


def as_runlog(obs: Optional[RunLog]) -> RunLog:
    """None -> the no-op singleton; a RunLog passes through."""
    return NULL_RUNLOG if obs is None else obs
