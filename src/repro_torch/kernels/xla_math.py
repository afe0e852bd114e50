"""Load and launch the elementwise kernels of XLA's float32 math
(`csrc/xla_math.cu`): `xla_fma`, `xla_erf_inv` and `xla_exp`.

The source compiles at first use into `build/repro_torch/libxla_math.so`
(`repro_torch.kernels.build`).  Nothing here runs when the module is
imported.  The launchers take operands that `repro_torch.kernels.ops` has
checked, allocate the output and enqueue one launch on the current CUDA
stream; they raise if the launch is refused and never fall back to the
plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "xla_math.cu"
#: most axes an `xla_fma` operand may have
MAX_DIMS = 8


def _bind(lib: ctypes.CDLL) -> None:
    p, f, i, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, \
        ctypes.c_longlong
    lib.xla_fma_launch.argtypes = [p, p, p, f, f, f, p, p, ll, i, p, p]
    lib.xla_erf_inv_launch.argtypes = [p, p, f, ll, p]
    lib.xla_exp_launch.argtypes = [p, p, ll, p]
    for fn in (lib.xla_fma_launch, lib.xla_erf_inv_launch,
               lib.xla_exp_launch):
        fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    return build.load(SOURCE, _bind)


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch_fma(a, b, c, shape, dev: torch.device) -> torch.Tensor:
    """out = a * b + c rounded once, broadcast to `shape`: each operand a
    float32 CUDA tensor that broadcasts to `shape`, or a Python float.
    The output is contiguous; at least one element."""
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    nd = len(shape)
    ptrs, scalars, contiguous = [], [], []
    geom = list(shape)
    for v in (a, b, c):
        if torch.is_tensor(v):
            e = v.expand(shape)
            ptrs.append(e.data_ptr())
            scalars.append(0.0)
            contiguous.append(int(e.is_contiguous()))
            geom += list(e.stride())
        else:
            ptrs.append(None)
            scalars.append(float(v))
            contiguous.append(0)
            geom += [0] * nd
    flags = (ctypes.c_int * 3)(*contiguous)
    geom_arr = (ctypes.c_longlong * max(1, len(geom)))(*geom)
    _raise("xla_fma", load().xla_fma_launch(
        *ptrs, *scalars, flags, out.data_ptr(), out.numel(), nd, geom_arr,
        _stream(dev)))
    return out


def launch_erf_inv(x: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * erf_inv(x) for a contiguous float32 CUDA tensor, at least
    one element."""
    out = torch.empty_like(x)
    _raise("xla_erf_inv", load().xla_erf_inv_launch(
        x.data_ptr(), out.data_ptr(), float(scale), x.numel(),
        _stream(x.device)))
    return out


def launch_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for a contiguous float32 CUDA tensor, at least one
    element."""
    out = torch.empty_like(x)
    _raise("xla_exp", load().xla_exp_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), _stream(x.device)))
    return out
