"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles at first use with `nvcc -gencode
arch=compute_90a,code=sm_90a` into its own library,
`build/repro_torch/lib<source stem>.so` under the repository root, with a
plain C interface that ctypes loads.  A library is rebuilt when its source,
or a header beside it (`csrc/*.cuh`), is newer.  `build` starts one nvcc
process per stale source, all at once.
Nothing here runs when the module is imported: the CPU tests import it on
machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
_REPO = _PKG.parents[1]
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last `build` spent in nvcc, by source file name (0.0 when the
#: library was up to date)
BUILD_S: Dict[str, float] = {}
#: nvcc's `-Xptxas -v` report (registers, spills, smem) of each source's
#: last build, by source file name
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    """Where the kernel libraries are built: `build/repro_torch/` at the
    repository root."""
    return _REPO / "build" / "repro_torch"


def library_path(source: Path) -> Path:
    """The library that `source` builds into."""
    return build_dir() / f"lib{source.stem}.so"


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, `/usr/local/cuda/bin/nvcc`
    or `nvcc` on PATH; raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return found


def _up_to_date(source: Path) -> bool:
    out = library_path(source)
    newest = max(p.stat().st_mtime
                 for p in (source, *source.parent.glob("*.cuh")))
    return out.exists() and out.stat().st_mtime >= newest


def build(*sources: Path) -> List[Path]:
    """Compile every stale source for sm_90a, one nvcc process each, all
    started together; returns the library paths in the order given.
    Raises, naming every source that failed, if any build fails."""
    stale = [s for s in sources if not _up_to_date(s)]
    for s in sources:
        if s not in stale:
            BUILD_S[s.name] = 0.0
    if stale:
        nvcc = nvcc_path()
        build_dir().mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in stale:
            tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            _, err = proc.communicate()
            BUILD_S[src.name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc exit {proc.returncode}\n"
                              f"{err}")
                continue
            BUILD_LOG[src.name] = err.strip()
            os.replace(tmp, library_path(src))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [library_path(s) for s in sources]


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build `source` if needed and load its library once per process;
    `bind` sets the argument and result types of its C functions."""
    with _LOCK:
        lib = _LIBS.get(source.name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)[0]))
            bind(lib)
            _LIBS[source.name] = lib
        return lib
