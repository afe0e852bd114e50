"""`repro_torch.analysis` — static checks for the port's reproducibility
and hot-path invariants: threefry key discipline (KEY*), host-sync hygiene
on the hot paths (TRC*), and whole-zoo shape contracts under
`FakeTensorMode` (SHP*).

Run as `python -m repro_torch.analysis` (see `--help`); it exits non-zero
on a finding that the committed `baseline.json` does not grandfather.
"""
from repro_torch.analysis.findings import (CLEAN_SUBTREES, Finding,
                                           assert_clean_subtrees,
                                           load_baseline, sort_findings,
                                           split_by_baseline, write_baseline)
from repro_torch.analysis.runner import DEFAULT_BASELINE, repo_root, run_all

__all__ = ["CLEAN_SUBTREES", "DEFAULT_BASELINE", "Finding",
           "assert_clean_subtrees", "load_baseline", "repo_root", "run_all",
           "sort_findings", "split_by_baseline", "write_baseline"]
