"""Structured findings + committed-baseline semantics for
`repro_torch.analysis`.

A `Finding` is one rule violation at one source location.  Baselines
grandfather known violations: a committed `baseline.json` lists findings
that existed when the rule landed, and `--fail-on-new` (the default) exits
nonzero only on findings NOT in the baseline.  Baseline identity is
`(rule, file, message)` — deliberately line-number-free, so unrelated edits
above a grandfathered violation don't churn the baseline file.

The bit-exactness-critical subtrees (`repro_torch/mc`, `repro_torch/core`,
`repro_torch/kernels`, `repro_torch/serve`, `repro_torch/device`) must stay
baseline-EMPTY: `assert_clean_subtrees` is the enforcement hook the test
suite pins.  `Finding` and the baseline file (version 1) are the JAX
package's, field for field, so a baseline written by either package loads
in the other.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

# Subtrees whose invariants back bit-identity guarantees; the committed
# baseline may never grandfather a finding inside them (tests pin this).
# serve/ is included: the serving engine's per-request committee results are
# promised bit-identical to the MC chunk forward at the request's key, so
# its key discipline is as load-bearing as the MC engine's.
CLEAN_SUBTREES = ("src/repro_torch/mc", "src/repro_torch/core",
                  "src/repro_torch/kernels", "src/repro_torch/serve",
                  "src/repro_torch/device")

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: where, what, and how to fix it."""
    rule: str          # e.g. "KEY001"
    file: str          # repo-relative posix path
    line: int          # 1-based; 0 when the finding is not line-anchored
    message: str       # one-line statement of the violation
    hint: str = ""     # fix hint shown next to the finding

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.message)

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "hint": self.hint}

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        hint = f" (hint: {self.hint})" if self.hint else ""
        return f"{loc} [{self.rule}] {self.message}{hint}"


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.file, f.line, f.rule, f.message))


def load_baseline(path: Path) -> List[Finding]:
    if not path.exists():
        return []
    doc = json.loads(path.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{doc.get('version')!r}")
    return [Finding(rule=f["rule"], file=f["file"], line=int(f.get("line", 0)),
                    message=f["message"], hint=f.get("hint", ""))
            for f in doc.get("findings", [])]


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    doc = {"version": BASELINE_VERSION,
           "findings": [f.to_dict() for f in sort_findings(findings)]}
    path.write_text(json.dumps(doc, indent=1) + "\n")


def split_by_baseline(findings: Sequence[Finding],
                      baseline: Sequence[Finding]
                      ) -> Tuple[List[Finding], List[Finding]]:
    """(new, grandfathered) partition of `findings` against `baseline`."""
    known = {f.key for f in baseline}
    new = [f for f in findings if f.key not in known]
    old = [f for f in findings if f.key in known]
    return new, old


def assert_clean_subtrees(baseline: Sequence[Finding]) -> List[str]:
    """Baseline entries inside the bit-exactness-critical subtrees (must be
    empty; returned as error strings for the caller to report)."""
    errors = []
    for f in baseline:
        if any(f.file.startswith(p + "/") or f.file == p
               for p in CLEAN_SUBTREES):
            errors.append(f"baseline grandfathers a finding in a "
                          f"bit-exactness-critical subtree: {f.format()}")
    return errors
