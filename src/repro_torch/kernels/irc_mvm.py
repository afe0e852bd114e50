"""Load and launch the Hopper IRC MVM kernel (`csrc/irc_mvm.cu`).

The source compiles at first use into `build/repro_torch/libirc_mvm.so`
(`repro_torch.kernels.build`).  Nothing here runs when the module is
imported: the CPU tests import it on machines without nvcc or a card.

`launch_chips` takes tensors that `repro_torch.kernels.ops` has already
checked (device, dtype, shapes, contiguity, tile) and enqueues the kernel
on the current CUDA stream; it raises if the launch is refused.  It never
falls back to the plain version.

The kernel's row tile `(bm, tm)` (bm word-line rows a thread block, tm of
them a thread) is one of `TILES`, the instantiations the source holds;
`repro_torch.kernels.autotune` picks one per problem from a table measured
on the card.  Every tile gives the same bits.  `DESIGN` names the kernel's
design in the launch counts (`ops.K1_LAUNCHES`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import IrcEpilogueParams

SOURCE = build.CSRC / "irc_mvm.cu"

_FLAG_NL, _FLAG_IR, _FLAG_SA, _FLAG_RANGE, _FLAG_DIFF = 1, 2, 4, 8, 16

#: the kernel's design: word lines read as bit masks, block currents kept
#: on chip, warps specialised by role (csrc/irc_mvm.cu's source note)
DESIGN = "bitmask"
#: the row tiles (bm, tm) the kernel is instantiated for (`launch_tile` in
#: csrc/irc_mvm.cu): bm = 32 tm word-line rows a thread block, lane l of a
#: compute warp owning rows l + 32 i (i < tm); (32, 1) spans 32 columns,
#: (64, 2) 16
TILES: Tuple[Tuple[int, int], ...] = ((32, 1), (64, 2))
#: the tile of a problem the tuning table has no entry for
DEFAULT_TILE: Tuple[int, int] = (32, 1)


def check_tile(tile: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """`tile` as a (bm, tm) pair of `TILES` (None: `DEFAULT_TILE`); raises
    ValueError for any other."""
    if tile is None:
        return DEFAULT_TILE
    t = tuple(int(v) for v in tile)
    if t not in TILES:
        raise ValueError(f"K1 has no tile {tuple(tile)}; its tiles are "
                         f"{TILES}")
    return t


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.irc_mvm_chips_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 7
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    return build.load(SOURCE, _bind)


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
                 params: IrcEpilogueParams,
                 tile: Optional[Tuple[int, int]] = None) -> None:
    """Enqueue one chip-batched launch on the current stream at row tile
    `tile` (None: `DEFAULT_TILE`).  x is [B,R] or [C,B,R], gp/gn [R,N] or
    [C,R,N]; a shared operand gets chip stride 0.  All tensors are
    contiguous float32 on one CUDA device."""
    bm, tm = check_tile(tile)
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
        bm, tm, stream)
    if err != 0:
        raise RuntimeError(f"irc_mvm_chips launch failed: cudaError {err}")
