"""Finds the benchmark's parts by the names `BENCHMARK.json` gives them.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric or plain reference is a file of its own under `bench/`:

    bench/configs/<config>.json       sizes, as run
    bench/traffic/<traffic>.json      a mix's parameters; its "driver" key
                                      names the driver that replays it
    bench/drivers/<driver>.py         set-up, window and check of one entry
                                      of the program
    bench/metrics/<metric>.py         `read(ctx)` of one per-layer metric
    bench/reference/<config>.py       the configuration's plain reference

A later change adds a model, a mix or a counter by adding such files and
their entries; no file here names any of them.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

#: the benchmark's own directory (`bench/`) and the checkout's root
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    """A name as the benchmark's files may carry it, or ValueError."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    """`BENCHMARK.json` at the checkout's root."""
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The cell called `name`, or KeyError naming the cells there are."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r}; cells: "
                   f"{', '.join(w['name'] for w in spec['workloads'])}")


def config_entry(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The `configs` entry called `name`."""
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r}")


def _read_json(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def load_config(spec: Dict[str, Any], name: str,
                root: Path = ROOT) -> Dict[str, Any]:
    """A configuration's sizes, from the file its entry names."""
    return _read_json(root / config_entry(spec, name)["file"])


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    """A traffic mix's parameters: `bench/traffic/<name>.json`."""
    return _read_json(bench_dir / "traffic" / f"{check_name(name)}.json")


def _load_module(path: Path, modname: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def _modname(kind: str, name: str) -> str:
    return f"bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)


def load_driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """`bench/drivers/<name>.py`."""
    return _load_module(bench_dir / "drivers" / f"{check_name(name)}.py",
                        _modname("driver", name))


def load_metric(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """`bench/metrics/<name>.py`, whose `read(ctx)` gives the metric or
    None where the run had nothing to read.  A name `<metric>.<suffix>`
    with no file of its own is read by the shared `<metric>.py`."""
    path = bench_dir / "metrics" / f"{check_name(name)}.py"
    base = name.split(".", 1)[0]
    if not path.is_file() and base != name:
        shared = bench_dir / "metrics" / f"{base}.py"
        if shared.is_file():
            path, name = shared, base
    return _load_module(path, _modname("metric", name))


def load_reference(config: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """`bench/reference/<config>.py`, the configuration's plain
    reference."""
    return _load_module(bench_dir / "reference" / f"{check_name(config)}.py",
                        _modname("reference", config))


def metrics_for(spec: Dict[str, Any], section: str,
                cell: str) -> List[Dict[str, Any]]:
    """The metrics of `section` ("end_to_end" | "per_layer") that cell
    `cell` reports: those that list it, and those that list no cells."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def find(spec: Dict[str, Any], cell: str,
         bench_dir: Path = BENCH_DIR,
         root: Path = ROOT) -> Dict[str, Any]:
    """Everything one run of `cell` needs, found by name: the cell, its
    configuration's sizes, its mix and the mix's driver module."""
    w = workload(spec, cell)
    traffic = load_traffic(w["traffic"], bench_dir)
    return {"cell": w,
            "config_name": w["config"],
            "config": load_config(spec, w["config"], root),
            "traffic": traffic,
            "driver": load_driver(traffic["driver"], bench_dir)}

