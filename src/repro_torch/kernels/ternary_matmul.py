"""Load, plan and launch the Hopper ternary matmul kernel
(`csrc/ternary_matmul.cu`), the ideal digital reference's product.

The source compiles at first use into `build/repro_torch/libternary_matmul.so`
(`repro_torch.kernels.build`).  Nothing here runs when the module is
imported.  `plan` lays out one launch from the shapes, x's address and the
card's SM count alone (the CPU tests hold it); `launch` takes tensors that
`repro_torch.kernels.ops` has already checked and enqueues the kernel on
the current CUDA stream; it raises if the launch is refused and never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "ternary_matmul.cu"

#: output rows and columns of a tile, depth of x per ring stage, stages
TILE_M, TILE_N, STAGE_K, STAGES = 128, 64, 64, 4
#: most blocks in a cluster (the portable cluster size)
MAX_SPLIT = 8
#: shared memory a block may use on the H100, bytes
SMEM_MAX = 232_448
#: how x reaches the ring, as the kernel numbers them: TMA from a tensor
#: map (base and row stride 16-byte aligned); 4-byte cp.async (f32 values
#: or bf16 pairs); 2-byte loads (bf16 rows that are not 4-byte aligned)
PATHS = {"tma": 0, "cp.async": 1, "ld.global": 2}


def smem_bytes(bf16: bool, kw: int, split: int) -> int:
    """A block's dynamic shared memory: 1 KB of alignment, the x ring, kw
    widened weight rows, the partial tile when K is split, the barriers
    (`smem_bytes` in the .cu)."""
    ring = STAGES * TILE_M * STAGE_K * (2 if bf16 else 4)
    red = (TILE_M + MAX_SPLIT) * (TILE_N + 8) * 4 if split > 1 else 0
    return 1024 + ring + kw * TILE_N * 2 + red + 8 * (2 * STAGES + 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `path` (a key of PATHS); `split` blocks per cluster, each
    a K range of `k_slice`; `kw` weight rows resident at once; `clusters`
    clusters that walk the `tiles_m` x `tiles_n` output tiles."""
    path: str
    split: int
    k_slice: int
    kw: int
    clusters: int
    tiles_m: int
    tiles_n: int

    @property
    def grid(self) -> int:
        return self.clusters * self.split


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _kw(bf16: bool, k_slice: int, split: int) -> int:
    """Weight rows resident at once: the K range's, or as many as the
    shared memory holds beside the ring (a multiple of 64)."""
    room = SMEM_MAX - smem_bytes(bf16, 0, split)
    return min(k_slice, room // (TILE_N * 2) // STAGE_K * STAGE_K)


def plan(B: int, K: int, N: int, bf16: bool, x_ptr: int, n_sm: int,
         max_clusters: Callable[[int, int], int]) -> Plan:
    """Lay out one launch of x [B,K] (float32, or bfloat16 when `bf16`) at
    address `x_ptr` on a card with `n_sm` SMs, of which `max_clusters(split,
    kw)` clusters of `split` blocks fit at once.

    - Path: TMA where x's base and row stride (K * element bytes) are
      multiples of 16 bytes; else 4-byte cp.async (any float32 x; bfloat16
      with an even K and a 4-byte aligned base); else 2-byte loads.
    - Split over K: while the output tiles fill at most half the SMs, each
      tile's K range splits over a cluster of blocks, in ranges that are
      multiples of 64 deep, none empty: the most blocks (up to 8) whose
      clusters all fit on the card at once.
    - Grid: a block takes most of an SM's shared memory, so at most
      `max_clusters` clusters run, and they walk the tiles (a persistent
      grid).
    - kw: the K range's weight rows, or as many as the shared memory holds;
      a deeper range is loaded in chunks."""
    elem = 2 if bf16 else 4
    if x_ptr % 16 == 0 and K * elem % 16 == 0:
        path = "tma"
    elif not bf16 or (x_ptr % 4 == 0 and K % 2 == 0):
        path = "cp.async"
    else:
        path = "ld.global"
    tiles_m, tiles_n = _ceil(B, TILE_M), _ceil(N, TILE_N)
    items = tiles_m * tiles_n
    split, k_slice = 1, _ceil(K, STAGE_K) * STAGE_K
    if 2 * items <= n_sm:
        for s in range(min(MAX_SPLIT, _ceil(K, STAGE_K)), 1, -1):
            ks = _ceil(_ceil(K, s), STAGE_K) * STAGE_K
            se = _ceil(K, ks)
            if items <= max_clusters(se, _kw(bf16, ks, se)):
                split, k_slice = se, ks
                break
    kw = _kw(bf16, k_slice, split)
    clusters = items if split > 1 else max(1, min(items, max_clusters(1, kw)))
    return Plan(path, split, k_slice, kw, clusters, tiles_m, tiles_n)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ternary_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = lib.ternary_matmul_max_clusters
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    return build.load(SOURCE, _bind)


_N_SM: Dict[int, int] = {}
_CLUSTERS: Dict[Tuple[int, bool, int, int], int] = {}


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def sm_count(dev: torch.device) -> int:
    """SMs of the card `dev`, read once per device."""
    idx = _index(dev)
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _N_SM[idx]


def max_clusters(dev: torch.device, bf16: bool, split: int, kw: int) -> int:
    """Clusters of `split` blocks with kw resident weight rows that the card
    `dev` holds at once (cudaOccupancyMaxActiveClusters), read once per
    (device, x type, split, kw)."""
    key = (_index(dev), bf16, split, kw)
    if key not in _CLUSTERS:
        n = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = load().ternary_matmul_max_clusters(int(bf16), split, kw,
                                                     ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"ternary_matmul occupancy query failed: "
                               f"cudaError {err}")
        _CLUSTERS[key] = n.value
    return _CLUSTERS[key]


@functools.lru_cache(maxsize=256)
def _plan_on(idx: int, B: int, K: int, N: int, bf16: bool,
             align: int) -> Plan:
    dev = torch.device("cuda", idx)
    return plan(B, K, N, bf16, align, sm_count(dev),
                lambda split, kw: max_clusters(dev, bf16, split, kw))


def plan_for(x: torch.Tensor, N: int) -> Plan:
    """The plan of one launch on the CUDA tensor x [B,K] with N columns;
    kept per device, shape, x type and x's address modulo 16, all a plan
    reads."""
    B, K = x.shape
    return _plan_on(_index(x.device), B, K, N, x.dtype == torch.bfloat16,
                    x.data_ptr() % 16)


def launch(x: torch.Tensor, w_t: torch.Tensor, out: torch.Tensor,
           pl: Optional[Plan] = None) -> Plan:
    """Enqueue one launch: x [B,K] contiguous float32 or bfloat16, w_t [K,N]
    contiguous int8, out [B,N] float32, all on one CUDA device, as `pl`
    lays it out (by default `plan_for(x, N)`; `chip_smoke.py` times
    another load path through it).  Returns the plan it launched."""
    B, K = x.shape
    N = w_t.shape[1]
    pl = pl or plan_for(x, N)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load().ternary_matmul_launch(
        x.data_ptr(), w_t.data_ptr(), out.data_ptr(), B, K, N,
        int(x.dtype == torch.bfloat16), PATHS[pl.path], pl.split, pl.k_slice,
        pl.kw, pl.clusters, stream)
    if err != 0:
        raise RuntimeError(f"ternary_matmul launch failed: cudaError {err}")
    return pl
