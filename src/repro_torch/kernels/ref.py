"""Plain PyTorch versions of the fused IRC MVM kernels.

`irc_mvm_chips_ref` computes what the CUDA kernel (`csrc/irc_mvm.cu`)
computes: the proposed design's single-shot crossbar MVM with its fused
nonideal epilogue.  Conductance planes arrive with device variation and HRS
leak pre-applied, and the stochastic periphery terms arrive as pre-sampled
inputs, so both versions are deterministic and compared on the same tensors.
The CPU tests hold this module against the JAX package's oracle, and the
card's smoke run holds the kernel against this module.

IR drop follows the kernels' suffix-cumsum chain (block 0 nearest the
driver); R is zero-padded at the far end to a multiple of the IR block,
which leaves the drop factors of real blocks unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

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
    """Accumulation nonlinearity ratio at activated-LRS count p."""
    p_raw = p.float()
    p = torch.clamp(p_raw, 0.0, 320.0)

    def horner(c):
        acc = torch.full_like(p, c[0])
        for x in c[1:]:
            acc = acc * p + x
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
    blocks = xb @ pb                                      # [..., nb, B, N]
    if params.apply_ir:
        suffix = torch.flip(torch.cumsum(torch.flip(blocks, [-3]), -3), [-3])
        cum = torch.cumsum(suffix, -3) - suffix[..., 0:1, :, :]
        factors = torch.clamp(1.0 - params.ir_alpha * cum, 0.0, 1.0)
        blocks = blocks * factors
    # near-driver block first, one add at a time: the kernel's order, so
    # the two agree to the bit wherever their block currents do
    line = blocks[..., 0, :, :]
    for k in range(1, nb):
        line = line + blocks[..., k, :, :]
    return line


def _mvm(x, ep, en, gp, gn, eps_sa, rnd_bits, params: IrcEpilogueParams,
         margin: bool):
    x = x.float()
    i_pos = _line_current(x, ep.float(), params)
    i_neg = _line_current(x, en.float(), params)
    p_pos = x @ gp.float()
    p_neg = x @ gn.float()
    if params.apply_nonlinearity:
        i_pos = i_pos * nl_ratio(p_pos)
        i_neg = i_neg * nl_ratio(p_neg)
    diff = i_pos - i_neg
    if params.output == "diff":
        return (diff, diff.abs()) if margin else diff
    p_pair = p_pos + p_neg
    if params.apply_sa:
        sigma = 0.5 * (params.sa_c0 + params.sa_c1 * p_pair
                       + params.sa_c2 * p_pair * p_pair + params.sa_extra)
        diff = diff + sigma * eps_sa
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


def near_tie_flips(out_a: torch.Tensor, out_b: torch.Tensor,
                   margin: torch.Tensor, tol: float = NEAR_TIE_TOL
                   ) -> Tuple[int, bool]:
    """(number of differing binary outputs, whether every difference lies
    where the plain version's decision margin is below `tol`)."""
    mism = out_a != out_b
    n = int(mism.sum())
    return n, bool(n == 0 or bool((margin[mism] < tol).all()))
