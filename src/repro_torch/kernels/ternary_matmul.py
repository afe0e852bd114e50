"""Load and launch the Hopper ternary matmul kernel
(`csrc/ternary_matmul.cu`), the ideal digital reference's product.

The source compiles at first use into `build/repro_torch/libternary_matmul.so`
(`repro_torch.kernels.build`).  Nothing here runs when the module is
imported.  `launch` takes tensors that `repro_torch.kernels.ops` has already
checked and enqueues the kernel on the current CUDA stream; it raises if
the launch is refused and never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "ternary_matmul.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ternary_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    return build.load(SOURCE, _bind)


def launch(x: torch.Tensor, w_t: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue one launch: x [B,K] contiguous float32 or bfloat16, w_t [K,N]
    contiguous int8, out [B,N] float32, all on one CUDA device."""
    B, K = x.shape
    N = w_t.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load().ternary_matmul_launch(
        x.data_ptr(), w_t.data_ptr(), out.data_ptr(), B, K, N,
        int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ternary_matmul launch failed: cudaError {err}")
