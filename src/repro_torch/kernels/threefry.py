"""Load and launch the die-sampling kernel (`csrc/threefry.cu`): JAX's
threefry-2x32 draws under either scheme, one launch per draw.

The source compiles at first use into `build/repro_torch/libthreefry.so`
(`repro_torch.kernels.build`).  Nothing here runs when the module is
imported.  The launchers take keys that `repro_torch.kernels.ops` has
checked and viewed as [L, 2] int64 on the card (words adjacent, keys
`keys.stride(0)` elements apart: 0 for one key expanded), allocate the
output and enqueue one launch on the current CUDA stream; they raise if the
launch is refused and never fall back to the plain versions
(`repro_torch.prng`).  `launch_tail` runs a draw's tail alone on given
words, for the checks that hold it against `prng.tail_plain`.  The
measured tail's quantile table travels by value in the launch's
parameters (`threefry_measured_launch`, `threefry_measured_tail_launch`),
and each block stages it in shared memory; the launchers refuse a table
that `prng.check_table` refuses.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "threefry.cu"
#: a draw's tail -> its code in the kernel and its output type
TAILS = {"bits": (0, torch.int64), "uniform": (1, torch.float32),
         "normal": (2, torch.float32), "lognormal": (3, torch.float32),
         "bernoulli": (4, torch.float32), "measured": (5, torch.float32)}


def _bind(lib: ctypes.CDLL) -> None:
    p, f, i, ll, u = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_uint)
    lib.threefry_draw_launch.argtypes = [p, ll, p, ll, ll, i, i, f, f, f, f,
                                         p]
    lib.threefry_pairs_launch.argtypes = [p, ll, p, u, p, ll, ll, p]
    fns = [lib.threefry_draw_launch, lib.threefry_pairs_launch]
    if hasattr(lib, "threefry_tail_launch"):  # builds before it have none
        lib.threefry_tail_launch.argtypes = [p, p, ll, i, f, f, f, f, p]
        fns.append(lib.threefry_tail_launch)
    if hasattr(lib, "threefry_measured_launch"):  # nor these
        lib.threefry_measured_launch.argtypes = [p, ll, p, ll, ll, i, f, p,
                                                 p, i, p]
        lib.threefry_measured_tail_launch.argtypes = [p, p, ll, f, p, p, i,
                                                      p]
        fns += [lib.threefry_measured_launch,
                lib.threefry_measured_tail_launch]
    for fn in fns:
        fn.restype = ctypes.c_int


def load(source: Path = SOURCE) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process;
    `source` may name another build of `threefry.cu` with the same C
    interface (`chip_smoke.py --threefry-baseline`)."""
    return build.load(source, _bind)


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"threefry {name} launch failed: cudaError {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _table_args(table) -> Tuple[ctypes.Array, ctypes.Array, int]:
    """A measured table (xp, fp of float32 values) as two host float
    arrays and their length."""
    xp, fp = table
    arr = ctypes.c_float * len(xp)
    return arr(*xp), arr(*fp), len(xp)


def launch_draw(keys: torch.Tensor, n: int, original: bool, tail: str,
                lo: float = 0.0, span: float = 1.0, factor: float = 1.0,
                p: float = 0.5, lib: Optional[ctypes.CDLL] = None,
                table=None) -> torch.Tensor:
    """n words under each of the keys [L, 2] through `tail` -> [L, n]
    (by `lib`, another build's library, where given); the measured tail
    takes `table` = (xp, fp), float32 values (`prng.check_table`)."""
    code, dtype = TAILS[tail]
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=keys.device)
    lib = lib or load()
    if tail == "measured":
        xp, fp, m = _table_args(table)
        err = lib.threefry_measured_launch(
            keys.data_ptr(), keys.stride(0), out.data_ptr(), keys.shape[0],
            n, int(original), factor, xp, fp, m, _stream(keys.device))
    else:
        err = lib.threefry_draw_launch(
            keys.data_ptr(), keys.stride(0), out.data_ptr(), keys.shape[0],
            n, int(original), code, lo, span, factor, p,
            _stream(keys.device))
    _raise("draw", err)
    return out


def launch_tail(words: torch.Tensor, tail: str, lo: float = 0.0,
                span: float = 1.0, factor: float = 1.0, p: float = 0.5,
                table=None) -> torch.Tensor:
    """A float32 tail alone on words (int64 [n] on the card, n a multiple
    of 8) -> float32 [n]; the draw's constants as `launch_draw` takes
    them."""
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    st = _stream(words.device)
    if tail == "measured":
        xp, fp, m = _table_args(table)
        err = load().threefry_measured_tail_launch(
            words.data_ptr(), out.data_ptr(), words.numel(), factor, xp, fp,
            m, st)
    else:
        err = load().threefry_tail_launch(
            words.data_ptr(), out.data_ptr(), words.numel(), TAILS[tail][0],
            lo, span, factor, p, st)
    _raise("tail", err)
    return out


def launch_pairs(keys: torch.Tensor, data: Optional[torch.Tensor],
                 scalar: int, num: int) -> torch.Tensor:
    """fold_in (num = 1; data [L] int64, or None for `scalar`) or the
    partitionable split (data None, scalar 0) of keys [L, 2] ->
    [L * num, 2] int64."""
    out = torch.empty((keys.shape[0] * num, 2), dtype=torch.int64,
                      device=keys.device)
    _raise("pairs", load().threefry_pairs_launch(
        keys.data_ptr(), keys.stride(0),
        None if data is None else data.data_ptr(),
        scalar, out.data_ptr(), keys.shape[0], num, _stream(keys.device)))
    return out
