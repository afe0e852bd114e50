"""Pass orchestration: discover files, run the three passes, time them."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.findings import Finding, sort_findings
from repro_torch.analysis.keys import run_key_pass
from repro_torch.analysis.registry import HOT_PATH_ROOTS
from repro_torch.analysis.trace import run_trace_pass
from repro_torch.runtime import DeviceLike


def repo_root() -> Path:
    """…/repo from …/repo/src/repro_torch/analysis/runner.py."""
    return Path(__file__).resolve().parents[3]


DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def _iter_py_files(paths: Iterable[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


def run_all(paths: Optional[List[Path]] = None, *,
            passes: Tuple[str, ...] = ("keys", "trace", "contracts"),
            device: DeviceLike = "cuda",
            ) -> Tuple[List[Finding], Dict[str, float]]:
    """Run the requested passes; (sorted findings, per-pass seconds).

    AST passes run over every .py under `paths` (default: src/repro_torch
    of this repo); the contract pass is path-independent — it runs the
    registries on fake tensors of `device` — so it runs whenever
    requested."""
    root = repo_root()
    if paths is None:
        paths = [root / "src" / "repro_torch"]
    files = _iter_py_files(paths)

    findings: List[Finding] = []
    timing: Dict[str, float] = {}

    def rel(p: Path) -> str:
        try:
            return p.resolve().relative_to(root).as_posix()
        except ValueError:
            return p.as_posix()

    if "keys" in passes:
        t0 = time.perf_counter()
        for f in files:
            findings.extend(run_key_pass(rel(f), f.read_text()))
        timing["keys"] = time.perf_counter() - t0
    if "trace" in passes:
        t0 = time.perf_counter()
        for f in files:
            roots = HOT_PATH_ROOTS.get(rel(f), set())
            findings.extend(run_trace_pass(rel(f), f.read_text(), roots))
        timing["trace"] = time.perf_counter() - t0
    if "contracts" in passes:
        from repro_torch.analysis.contracts import run_contract_pass
        t0 = time.perf_counter()
        findings.extend(run_contract_pass(device))
        timing["contracts"] = time.perf_counter() - t0
    timing["total"] = sum(timing.values())
    return sort_findings(findings), timing
