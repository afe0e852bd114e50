"""Plain PyTorch versions of the port's CUDA kernels.

`ternary_matmul_ref` computes what `csrc/ternary_matmul.cu` computes: the
ideal digital product of float inputs and int8 ternary weights.
`flash_attention_ref` computes what `csrc/flash_attention.cu` computes:
causal softmax attention, with the scores materialised.
`irc_mvm_chips_ref` computes what the CUDA kernel (`csrc/irc_mvm.cu`)
computes: the proposed design's single-shot crossbar MVM with its fused
nonideal epilogue.  Conductance planes arrive with device variation and HRS
leak pre-applied, and the stochastic periphery terms arrive as pre-sampled
inputs, so both versions are deterministic and compared on the same tensors.
The CPU tests hold this module against the JAX package's oracle, and the
card's smoke run holds the kernel against this module.

IR drop follows the kernels' suffix-cumsum chain (block 0 nearest the
driver); R is zero-padded at the far end to a multiple of the IR block,
which leaves the drop factors of real blocks unchanged.  The IRC MVM adds
and rounds in the JAX oracle's float32 order on XLA's CPU backend
(`repro_torch.xla_order`): two-level scans of 16 for the suffix sums and
their prefix sums, sequential block sums, and a fused multiply-add exactly
where XLA contracts one; so it gives the oracle's bits, and the kernel,
which follows the same order op for op, gives this module's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import xla_order as xo

#: Binary SA outputs of two implementations may differ only where the plain
#: version's decision margin is below this (LRS units).  Line currents reach
#: ~300 units, where one float32 ulp is 3e-5; summing 18 IR blocks in
#: another order moves the difference by a few ulps, so 1e-3 bounds the
#: reordering with room and is still far below the SA's 2-unit resolution.
NEAR_TIE_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class IrcEpilogueParams:
    """Static epilogue constants (from MacroSpec, in LRS units)."""
    ir_alpha: float = 1.5e-5
    ir_block: int = 32
    sense_low: float = 35.0
    sense_high: float = 300.0
    sa_c0: float = 2.0
    sa_c1: float = 0.012
    sa_c2: float = 2.2e-5
    sa_extra: float = 0.0
    apply_nonlinearity: bool = True
    apply_ir: bool = True
    apply_sa: bool = True
    apply_range: bool = True
    output: str = "binary"            # "binary" | "diff"

    @classmethod
    def from_macro(cls, spec, **overrides) -> "IrcEpilogueParams":
        """Epilogue constants of a `MacroSpec`, with keyword overrides."""
        kw = dict(ir_alpha=spec.ir_alpha, ir_block=spec.ir_block,
                  sense_low=spec.sense_low_units,
                  sense_high=spec.sense_high_units,
                  sa_c0=spec.sa_c0, sa_c1=spec.sa_c1, sa_c2=spec.sa_c2)
        kw.update(overrides)
        return cls(**kw)


# exact published piecewise quartic (Sec. III-C), clamped to the fit domain
_NL_LO = (1.0286e-8, -3.79e-6, 5.3e-4, -3.92e-2, 2.5)
_NL_HI = (1.8063e-11, -3.204e-8, 2.2495e-5, -8.057e-3, 1.707)


def nl_ratio(p: torch.Tensor) -> torch.Tensor:
    """Accumulation nonlinearity ratio at activated-LRS count p; each Horner
    step is one fused multiply-add, as XLA contracts the reference's."""
    p_raw = p.float()
    p = torch.clamp(p_raw, 0.0, 320.0)

    def horner(c):
        acc = torch.full_like(p, c[0])
        for x in c[1:]:
            acc = xo.fma(acc, p, x)
        return acc

    ratio = torch.where(p <= 140.0, horner(_NL_LO), horner(_NL_HI))
    return torch.where(p_raw < 0.5, torch.ones_like(ratio), ratio)


def _line_current(x: torch.Tensor, eplane: torch.Tensor,
                  params: IrcEpilogueParams) -> torch.Tensor:
    """One plane through the IR-drop block model: x [..., B, R] and
    eplane [..., R, N] (leading axes broadcast) -> [..., B, N]."""
    blk = params.ir_block
    pad = (-x.shape[-1]) % blk
    if pad:
        x = F.pad(x, (0, pad))
        eplane = F.pad(eplane, (0, 0, 0, pad))
    R, N = eplane.shape[-2:]
    nb = R // blk
    xb = x.reshape(x.shape[:-1] + (nb, blk)).transpose(-3, -2)
    pb = eplane.reshape(eplane.shape[:-2] + (nb, blk, N))
    if xb.shape[-2] == 1 or N == 1:
        # one word-line row or one column takes a matrix-vector path (torch
        # on the CPU, cuBLAS on the card) that sums the block in another
        # order; the explicit chain keeps the ascending order of XLA's dot
        # and of the CUDA kernel
        blocks = xo.seq_fma_sum(xb.unsqueeze(-1), pb.unsqueeze(-3), -2)
    else:
        blocks = xb @ pb                                  # [..., nb, B, N]
    if not params.apply_ir:
        return xo.seq_sum(blocks, -3)
    # block by block, so that no temporary is larger than one block's
    # currents: suffix sums, their prefix sums, factors, weighted sum
    items = blocks.unbind(-3)
    suffix = list(xo.scan16_iter(items[::-1]))[::-1]
    line = None
    for k, pre in enumerate(xo.scan16_iter(suffix)):
        factor = torch.clamp(xo.fma(-params.ir_alpha, pre - suffix[0], 1.0),
                             0.0, 1.0)
        line = (items[0] * factor if line is None
                else xo.fma(items[k], factor, line))
    return line


def _is_bits(t: torch.Tensor) -> bool:
    return bool(((t == 0) | (t == 1)).all())


def _counts(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Activated-LRS counts x [..., B, R] @ g [..., R, N] as one fused
    multiply-add chain from +0 over R in ascending order, the CUDA kernel's
    order.  With x and g all 0 or 1 every partial sum is an exact integer,
    so a matmul gives the same bits in whatever order the backend sums;
    other values take the chain row by row."""
    if _is_bits(x) and _is_bits(g):
        return x @ g
    shape = torch.broadcast_shapes(x.shape[:-2], g.shape[:-2]) + (
        x.shape[-2], g.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for r in range(x.shape[-1]):
        acc = xo.fma(x[..., r:r + 1], g[..., r:r + 1, :], acc)
    return acc


def _mvm(x, ep, en, gp, gn, eps_sa, rnd_bits, params: IrcEpilogueParams,
         margin: bool):
    x = x.float()
    i_pos = _line_current(x, ep.float(), params)
    i_neg = _line_current(x, en.float(), params)
    p_pos = _counts(x, gp.float())
    p_neg = _counts(x, gn.float())
    if params.apply_nonlinearity:
        r_pos, r_neg = nl_ratio(p_pos), nl_ratio(p_neg)
        i_neg = i_neg * r_neg
        # XLA contracts i_pos * r_pos - i_neg into one fused multiply-add,
        # except where the sensing window reads the product i_pos * r_pos
        if params.apply_range and params.output == "binary":
            i_pos = i_pos * r_pos
            diff = i_pos - i_neg
        else:
            diff = xo.fma(i_pos, r_pos, -i_neg)
    else:
        diff = i_pos - i_neg
    if params.output == "diff":
        return (diff, diff.abs()) if margin else diff
    p_pair = p_pos + p_neg
    if params.apply_sa:
        sigma = 0.5 * (xo.fma(params.sa_c2 * p_pair, p_pair,
                              xo.fma(params.sa_c1, p_pair, params.sa_c0))
                       + params.sa_extra)
        diff = xo.fma(sigma, eps_sa, diff)
    out = (diff > 0).float()
    gap = diff.abs()
    if params.apply_range:
        lo = torch.minimum(i_pos, i_neg)
        hi = torch.maximum(i_pos, i_neg)
        fail = (lo < params.sense_low) | (hi > params.sense_high)
        out = torch.where(fail, rnd_bits, out)
        gap = torch.minimum(gap, torch.minimum((lo - params.sense_low).abs(),
                                               (hi - params.sense_high).abs()))
    return (out, gap) if margin else out


def irc_mvm_chips_ref(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
                      gp: torch.Tensor, gn: torch.Tensor,
                      eps_sa: torch.Tensor, rnd_bits: torch.Tensor,
                      params: IrcEpilogueParams, *, margin: bool = False):
    """Plain version of the chip-batched kernel.

    x [B, R] (word lines shared by every chip) or [C, B, R] (per chip);
    ep/en [C, R, N]; gp/gn [R, N] (shared placement) or [C, R, N];
    eps_sa/rnd_bits [C, B, N] -> [C, B, N].  With `margin=True` it also
    returns each output's decision margin: the distance of the SA input from
    0 and, with the sensing range on, of the line currents from the window's
    edges — what `near_tie_flips` reads."""
    C = ep.shape[0]
    res = _mvm(x, ep, en, gp, gn, eps_sa, rnd_bits, params, margin)
    B, N = eps_sa.shape[-2:]
    if margin:
        return tuple(r.expand(C, B, N) for r in res)
    return res.expand(C, B, N)


def irc_mvm_ref(x, ep, en, gp, gn, eps_sa, rnd_bits,
                params: IrcEpilogueParams, *, margin: bool = False):
    """Plain version of the single-chip kernel: x [B, R], planes [R, N],
    eps_sa/rnd_bits [B, N] -> [B, N] (the C = 1 case of the chip-batched
    version)."""
    res = irc_mvm_chips_ref(x, ep[None], en[None], gp, gn, eps_sa[None],
                            rnd_bits[None], params, margin=margin)
    return tuple(r[0] for r in res) if margin else res[0]


def ternary_matmul_ref(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """Plain version of the ternary matmul kernel: x [B,K] float32 or
    bfloat16, w_t [K,N] int8 in {-1,0,+1} -> [B,N] float32."""
    return x.float() @ w_t.float()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain version of the flash-attention kernel: softmax attention with
    float32 scores.  q [H,Sq,hd], k/v [H,Sk,hd] -> [H,Sq,hd] in q's dtype;
    scores scaled by hd^-0.5, and with `causal` every key j > query i
    masked with -1e30, as the JAX package's oracle does."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def bf16x3_split(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """float32 p -> (hi, mid, lo), three bfloat16 tensors: hi = bf16(p),
    mid = bf16(p - hi), lo = bf16(p - hi - mid), each rounded to nearest
    even.  hi + mid + lo == p exactly in float32 wherever |p| >= 2^-110
    (p's last bit is then no finer than 2^-133, bfloat16's smallest
    subnormal step; float32 and bfloat16 share their exponent range);
    below that lo rounds, by at most 2^-134.  The bf16 flash attention
    kernel splits its softmax weights so, in registers, before its three
    P V passes (a weight under 2^-110 is that small against its row's
    largest, 1); this plain version states and tests the split, and no
    path calls it."""
    p = p.float()
    hi = p.bfloat16()
    rest = p - hi.float()
    mid = rest.bfloat16()
    return hi, mid, (rest - mid.float()).bfloat16()


def _top16(v: torch.Tensor) -> torch.Tensor:
    """float32 v with its low 16 bits cleared (a bf16 value, truncated)."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def bf16x3_split_masked(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """float32 x -> (hi, mid, lo), three bfloat16 tensors, by truncation:
    hi = x's top 16 bits, rest = x - hi, mid = rest's top 16 bits, lo =
    rest - mid truncated to bf16.  hi + mid + lo == x exactly in float32
    wherever |x| >= 2^-110 (below, lo loses the bits under bf16's smallest
    subnormal step, 2^-133); unlike `bf16x3_split`, hi never rounds up to
    Inf near FLT_MAX.  An Inf or NaN stays in hi (a NaN as a NaN, whatever
    its payload) with mid = lo = 0, so Inf * 1 = Inf and Inf * 0 = NaN as
    in an f32 product.  The ternary matmul kernel splits its float32 x so,
    in registers (`split3` in csrc/ternary_matmul.cu), before its three
    bf16 passes; this plain version states and tests the split, and no
    path calls it."""
    x = x.float()
    nan = torch.isnan(x)
    hi = _top16(torch.where(nan, torch.full_like(x, float("nan")), x))
    rest = x - hi
    rest = torch.where(torch.isnan(rest), torch.zeros_like(rest), rest)
    mid = _top16(rest)
    lo = _top16(rest - mid)
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def near_tie_flips(out_a: torch.Tensor, out_b: torch.Tensor,
                   margin: torch.Tensor, tol: float = NEAR_TIE_TOL
                   ) -> Tuple[int, bool]:
    """(number of differing binary outputs, whether every difference lies
    where the plain version's decision margin is below `tol`)."""
    mism = out_a != out_b
    n = int(mism.sum())
    return n, bool(n == 0 or bool((margin[mism] < tol).all()))
