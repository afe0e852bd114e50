"""Shape-contract pass: run every registered entry point on fake tensors.

`FakeTensorMode` runs the real code on tensors that carry a shape, a dtype
and a device and no storage — zero FLOPs, zero host<->device traffic — so
the whole detector, the MC engines, the QAT step and the LM zoo are
type-checked end to end.  The kernels answer through their custom ops'
fake implementations (`repro_torch.kernels.ops`), so the kernel routes are
checked too, on fake CUDA tensors on the card.  Rules:

  SHP001  a contract raised under fake tensors (shape error, broken config,
          signature drift, a value read on a path that should not read one
          — whatever the fake run surfaced)
  SHP002  the contract ran but the output shape/dtype/device/tree disagrees
          with the declared expectation
  SHP003  an arch marked "live" in `configs.registry.ARCH_STATUS` has no
          shape contract — live code the pass cannot vouch for
  SHP004  a registered arch missing from ARCH_STATUS — quarantine status
          must be EXPLICIT: the pass never silently skips an arch
"""
from __future__ import annotations

import traceback
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import port_contracts, shape_contracts
from repro_torch.runtime import DeviceLike, resolve_device

REGISTRY_FILE = "src/repro_torch/configs/registry.py"
VALID_STATUSES = ("live", "legacy")


def run_contract_pass(device: DeviceLike = "cuda") -> List[Finding]:
    """Every contract on fake tensors of `device` (the card unless the
    caller asks for the CPU), plus the registry's status checks."""
    from repro_torch.configs.registry import ARCH_STATUS, list_archs

    device = resolve_device(device)
    findings: List[Finding] = []
    known_archs = list(list_archs()) + ["yolo-irc"]
    for arch in known_archs:
        status = ARCH_STATUS.get(arch)
        if status not in VALID_STATUSES:
            findings.append(Finding(
                rule="SHP004", file=REGISTRY_FILE, line=0,
                message=f"arch {arch!r} has no liveness status "
                        f"(got {status!r})",
                hint="add it to ARCH_STATUS as 'live' or 'legacy' — the "
                     "shape pass never skips an arch silently"))
    for arch, status in ARCH_STATUS.items():
        if arch not in known_archs:
            findings.append(Finding(
                rule="SHP004", file=REGISTRY_FILE, line=0,
                message=f"ARCH_STATUS entry {arch!r} is not a registered "
                        f"arch",
                hint="remove the stale entry or register the arch"))

    contracts = shape_contracts() + port_contracts()
    covered = {c.arch for c in contracts if c.arch}
    for arch in known_archs:
        if ARCH_STATUS.get(arch) == "live" and arch not in covered:
            findings.append(Finding(
                rule="SHP003", file=REGISTRY_FILE, line=0,
                message=f"live arch {arch!r} has no shape contract",
                hint="declare one in repro_torch.analysis.registry."
                     "shape_contracts()"))

    for c in contracts:
        try:
            mismatch = c.run(device)
        except Exception as e:                        # noqa: BLE001
            tb = traceback.format_exc().strip().splitlines()[-1]
            findings.append(Finding(
                rule="SHP001", file=c.file, line=0,
                message=f"contract {c.name} raised under fake tensors: "
                        f"{type(e).__name__}: {e}".splitlines()[0][:300],
                hint=f"reproduce with ShapeContract.trace on the declared "
                     f"inputs ({tb[:120]})"))
            continue
        if mismatch:
            findings.append(Finding(
                rule="SHP002", file=c.file, line=0,
                message=f"contract {c.name}: {mismatch}",
                hint="either the entry point or the declared spec is wrong "
                     "— fix the regression or update the contract"))
    return findings
