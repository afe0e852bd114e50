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
import math

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "xla_math.cu"
#: most axes an `xla_fma` operand may have
MAX_DIMS = 8
#: most axes, after coalescing, of `xla_fma`'s 32-bit paths
DIMS_32 = 4
#: `xla_fma`'s kernel paths, as the launcher numbers them
FMA_PATHS = {"64": 0, "32": 1, "vec4": 2}


def _bind(lib: ctypes.CDLL) -> None:
    p, f, i, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, \
        ctypes.c_longlong
    lib.xla_fma_launch.argtypes = [p, p, p, f, f, f, p, ll, i, p, i, p]
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


def fma_geometry(shape, operands):
    """The launch geometry of `out = a * b + c` over `shape`: the axes
    coalesced, and the kernel path.  `operands` holds, per slot, a CUDA
    tensor already expanded to `shape` or a Python float.

    Axes of size 1 go; two neighbouring axes merge where every tensor
    operand steps over the outer one as over the whole inner one (the
    output is contiguous, so it always does).  Returns (sizes, strides per
    slot, 0 for a scalar, path): path "vec4" when the innermost axis is a
    multiple of 4 long and every tensor operand is contiguous along it
    (with a 16-byte aligned pointer and other strides that are multiples
    of 4) or broadcast along it, "32" when every index and offset fits in
    31 bits and at most `DIMS_32` axes are left, "64" otherwise."""
    dims = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        st = [v.stride(d) if torch.is_tensor(v) else 0 for v in operands]
        if dims and all(p == q * size for p, q in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    dims = dims or [(1, [0, 0, 0])]
    sizes = [size for size, _ in dims]
    strides = [[st[k] for _, st in dims] for k in range(3)]
    tensors = [k for k, v in enumerate(operands) if torch.is_tensor(v)]
    n = math.prod(sizes)
    reach = max((sum((sz - 1) * st for sz, st in zip(sizes, strides[k]))
                 for k in tensors), default=0)
    if n >= 2**31 or reach >= 2**31 or len(sizes) > DIMS_32:
        return sizes, strides, "64"
    vec = sizes[-1] % 4 == 0 and all(
        strides[k][-1] == 0 or (
            strides[k][-1] == 1 and operands[k].data_ptr() % 16 == 0
            and all(st % 4 == 0 for st in strides[k][:-1]))
        for k in tensors)
    return sizes, strides, "vec4" if vec else "32"


def launch_fma(a, b, c, shape, dev: torch.device) -> torch.Tensor:
    """out = a * b + c rounded once, broadcast to `shape`: each operand a
    float32 CUDA tensor that broadcasts to `shape`, or a Python float.
    The output is contiguous; at least one element."""
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    ops = [v.expand(shape) if torch.is_tensor(v) else float(v)
           for v in (a, b, c)]
    sizes, strides, path = fma_geometry(shape, ops)
    geom = sizes + strides[0] + strides[1] + strides[2]
    geom_arr = (ctypes.c_longlong * len(geom))(*geom)
    ptrs = [v.data_ptr() if torch.is_tensor(v) else None for v in ops]
    scalars = [0.0 if torch.is_tensor(v) else v for v in ops]
    _raise("xla_fma", load().xla_fma_launch(
        *ptrs, *scalars, out.data_ptr(), out.numel(), len(sizes), geom_arr,
        FMA_PATHS[path], _stream(dev)))
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
