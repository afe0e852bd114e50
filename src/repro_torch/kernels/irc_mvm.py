"""Build, load and launch the Hopper IRC MVM kernel (`csrc/irc_mvm.cu`).

The source compiles at first use with `nvcc -gencode
arch=compute_90a,code=sm_90a` into `build/repro_torch/libirc_mvm.so` under
the repository root, a library with a plain C interface that ctypes loads.  Nothing here runs when the module is imported:
the CPU tests import it on machines without nvcc or a card.

`launch_chips` takes tensors that `repro_torch.kernels.ops` has already
checked (device, dtype, shapes, contiguity) and enqueues the kernel on the
current CUDA stream; it raises if the launch is refused.  It never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.ref import IrcEpilogueParams

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "irc_mvm.cu"
_REPO = _PKG.parents[1]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: seconds the last `load()` spent in nvcc (0.0 when already built)
BUILD_S = 0.0
#: nvcc's `-Xptxas -v` report of the last build (registers, spills, smem)
BUILD_LOG = ""

_FLAG_NL, _FLAG_IR, _FLAG_SA, _FLAG_RANGE, _FLAG_DIFF = 1, 2, 4, 8, 16


def build_dir() -> Path:
    """Where the kernel library is built: `build/repro_torch/` at the
    repository root."""
    return _REPO / "build" / "repro_torch"


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, `/usr/local/cuda/bin/nvcc`
    or `nvcc` on PATH; raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the IRC MVM kernel builds only "
                           "where the CUDA toolkit is installed")
    return found


def build(verbose: bool = False) -> Path:
    """Compile `csrc/irc_mvm.cu` for sm_90a; returns the library path.
    Rebuilds when the source is newer than the library."""
    global BUILD_S
    out = build_dir() / "libirc_mvm.so"
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        BUILD_S = 0.0
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_S = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    global BUILD_LOG
    BUILD_LOG = proc.stderr.strip()
    if verbose:
        print(BUILD_LOG)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.irc_mvm_chips_launch
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 7
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def epilogue_flags(params: IrcEpilogueParams) -> int:
    """The kernel's effect bitmask for an epilogue configuration."""
    if params.output not in ("binary", "diff"):
        raise ValueError(f"unknown output {params.output!r}")
    return ((_FLAG_NL if params.apply_nonlinearity else 0)
            | (_FLAG_IR if params.apply_ir else 0)
            | (_FLAG_SA if params.apply_sa else 0)
            | (_FLAG_RANGE if params.apply_range else 0)
            | (_FLAG_DIFF if params.output == "diff" else 0))


def launch_chips(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
                 gp: torch.Tensor, gn: torch.Tensor, eps_sa: torch.Tensor,
                 rnd_bits: torch.Tensor, out: torch.Tensor,
                 params: IrcEpilogueParams) -> None:
    """Enqueue one chip-batched launch on the current stream.  x is [B,R]
    or [C,B,R], gp/gn [R,N] or [C,R,N]; a shared operand gets chip stride 0.
    All tensors are contiguous float32 on one CUDA device."""
    if params.ir_block != 32:
        raise ValueError(f"the kernel's IR block is 32 rows, got "
                         f"{params.ir_block}")
    C, R, N = ep.shape
    B = x.shape[-2]
    x_stride = B * R if x.ndim == 3 else 0
    g_stride = R * N if gp.ndim == 3 else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load().irc_mvm_chips_launch(
        x.data_ptr(), ep.data_ptr(), en.data_ptr(), gp.data_ptr(),
        gn.data_ptr(), eps_sa.data_ptr(), rnd_bits.data_ptr(), out.data_ptr(),
        C, B, R, N, x_stride, g_stride,
        params.ir_alpha, params.sense_low, params.sense_high, params.sa_c0,
        params.sa_c1, params.sa_c2, params.sa_extra, epilogue_flags(params),
        stream)
    if err != 0:
        raise RuntimeError(f"irc_mvm_chips launch failed: cudaError {err}")
