"""Load and launch the Hopper causal flash-attention kernels
(`csrc/flash_attention.cu`, both on the tensor cores through TMA tensor
maps, `csrc/hopper.cuh`): bfloat16 inputs in one launch; float32 inputs
in two, a pre-pass that splits k and v exactly into three bfloat16 parts
each (into scratch allocated here) and the attention, which splits q in
registers.

The source compiles at first use into
`build/repro_torch/libflash_attention.so` (`repro_torch.kernels.build`).
Nothing here runs when the module is imported.  `check` holds the
operands to what the kernel takes; `launch` enqueues one launch on the
current CUDA stream and raises if it is refused, never falling back to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "flash_attention.cu"
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: query and key tile sizes it is compiled for
TILES = (32, 64)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_split
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    return build.load(SOURCE, _bind)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int,
          bk: int) -> None:
    """Raise ValueError unless q [H,Sq,hd] and k/v [H,Sk,hd] share one
    dtype (float32 or bfloat16) and device, hd is a compiled head dim and
    bq/bk are compiled tile sizes."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or (
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]):
        raise ValueError(f"flash_attention takes q [H,Sq,hd] and k/v "
                         f"[H,Sk,hd], got {tuple(q.shape)}, {tuple(k.shape)}"
                         f" and {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q, k and v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v must be on one device, got {q.device}"
                         f", {k.device} and {v.device}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} is not one of {HEAD_DIMS}")
    if bq not in TILES or bk not in TILES:
        raise ValueError(f"bq and bk must be in {TILES}, got {bq} and {bk}")


def parts_numel(H: int, Sk: int, hd: int) -> int:
    """bfloat16 elements of the float32 leg's scratch: three parts each of
    k and v [H,Sk,hd]."""
    return 6 * H * Sk * hd


def _aligned(*ts: torch.Tensor):
    """The operands, each copied if it does not start on 16 bytes, as a TMA
    tensor map and the split's float4 loads need."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def split(k: torch.Tensor, v: torch.Tensor, parts: torch.Tensor) -> None:
    """Enqueue the float32 leg's pre-pass alone: k and v (checked,
    contiguous, float32, on the card) into `parts` (bfloat16,
    `parts_numel` elements)."""
    k, v = _aligned(k, v)
    H, Sk, hd = k.shape
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = load().flash_attention_split(
        k.data_ptr(), v.data_ptr(), parts.data_ptr(), H, Sk, hd, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention split failed: cudaError {err}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, bq: int, bk: int) -> None:
    """Enqueue one op call on checked, contiguous CUDA operands (one launch
    for bfloat16, the split and the attention for float32); `out` is
    [H,Sq,hd] in q's dtype.  An operand that does not start on 16 bytes is
    copied first."""
    q, k, v = _aligned(q, k, v)
    H, Sq, hd = q.shape
    Sk = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    parts = None if bf16 else torch.empty(
        parts_numel(H, Sk, hd), dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if bf16 else parts.data_ptr(), H, Sq, Sk, hd, bq, bk, int(bf16),
        hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
