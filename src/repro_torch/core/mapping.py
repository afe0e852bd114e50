"""Weight -> crossbar conductance-plane mapping (paper Sec. IV-B, Figs. 12-13).

`ternary_planes` (proposed design): each weight column maps to a
differential (G+, G-) bit-line pair; +1 -> (LRS, HRS), -1 -> (HRS, LRS),
0 -> (HRS, HRS).  `binary_planes` (baseline design): weights in {-1,+1} map
to one convolution bit-line (LRS for +1) compared against a shared reference
bit-line of half conductance.  Row 0 is nearest the bit-line driver; the
proposed design's <= 32 extra bias rows and the baseline's in-memory BN
rows sit there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import xla_order as xo
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO


@dataclasses.dataclass
class MappedLayer:
    """A linear layer mapped onto crossbar conductance planes.

    g_pos/g_neg: [rows_mapped, n_out] float, row 0 nearest the driver
    ({0,1}; the baseline's reference line is 0.5); the `bias_rows` leading
    rows are always on: common-mode bias (LRS on both planes) or the
    baseline's in-memory BN rows."""
    g_pos: torch.Tensor
    g_neg: torch.Tensor
    bias_rows: int
    scheme: str                    # "ternary" | "binary"
    fan_in: int

    @property
    def rows(self) -> int:
        """Total mapped rows, bias rows included."""
        return self.g_pos.shape[0]

    @property
    def n_out(self) -> int:
        """Number of output columns (bit-line pairs)."""
        return self.g_pos.shape[1]


def ternary_planes(w_t: torch.Tensor, bias_rows: int = 0) -> MappedLayer:
    """Map ternary weights [fan_in, n_out] to differential planes
    [bias_rows + fan_in, n_out], bias rows first."""
    w_t = w_t.float()
    g_pos = (w_t > 0.5).float()
    g_neg = (w_t < -0.5).float()
    if bias_rows:
        ones = torch.ones((bias_rows, w_t.shape[1]), dtype=torch.float32,
                          device=w_t.device)
        g_pos = torch.cat([ones, g_pos], dim=0)
        g_neg = torch.cat([ones, g_neg], dim=0)
    return MappedLayer(g_pos=g_pos, g_neg=g_neg, bias_rows=bias_rows,
                       scheme="ternary", fan_in=w_t.shape[0])


def binary_planes(w_b: torch.Tensor,
                  bn_bias_units: Optional[torch.Tensor] = None,
                  spec: MacroSpec = DEFAULT_MACRO) -> MappedLayer:
    """Baseline mapping of binary weights [fan_in, n_out]: `g_pos` is the
    convolution line (LRS for +1), `g_neg` the shared reference line at 0.5
    everywhere, so ideally I_ref = p/2 for p activated rows.  With
    `bn_bias_units` [n_out] (in-memory BN, Fig. 13a), `spec.bn_rows`
    always-on leading rows carry round(b) clipped to +-bn_rows: |b| of them
    LRS on the convolution line (b > 0) or on the reference line (b < 0)."""
    w_b = w_b.float()
    fan_in, n_out = w_b.shape
    conv = (w_b > 0).float()
    ref = torch.full((fan_in, n_out), 0.5, dtype=torch.float32,
                     device=w_b.device)
    bn = 0
    if bn_bias_units is not None:
        bn = spec.bn_rows
        b = torch.clamp(torch.round(bn_bias_units.float()), -bn, bn)
        r = torch.arange(bn, dtype=torch.float32, device=w_b.device)[:, None]
        conv_bn = (r < torch.clamp(b, min=0)[None, :]).float()
        ref_bn = (r < torch.clamp(-b, min=0)[None, :]).float()
        conv = torch.cat([conv_bn, conv], dim=0)
        ref = torch.cat([ref_bn, ref], dim=0)
    return MappedLayer(g_pos=conv, g_neg=ref, bias_rows=bn, scheme="binary",
                       fan_in=fan_in)


def fold_bn_to_bias_units(gamma: torch.Tensor, beta: torch.Tensor,
                          mean: torch.Tensor, var: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Fold BN into pre-activation bias units for in-memory BN: for gamma
    > 0, sign(gamma * (y - mean) / std + beta) = sign(y + beta * std /
    gamma - mean).  `binary_planes` rounds the units to whole LRS cells
    (the BN-precision fragility the paper's proposed design removes)."""
    std = xo.sqrt(var + eps)
    return beta * std / torch.clamp(gamma, min=1e-6) - mean


def extend_inputs(x_bits: torch.Tensor, mapped: MappedLayer) -> torch.Tensor:
    """Prefix the always-on rows: [..., fan_in] -> [..., rows]."""
    return extend_rows(x_bits, mapped.rows - mapped.fan_in)


def extend_rows(x_bits: torch.Tensor, lead: int) -> torch.Tensor:
    """Prefix `lead` always-on word-lines to [..., fan_in] float bits."""
    x = x_bits.float()
    if lead == 0:
        return x
    ones = torch.ones(x.shape[:-1] + (lead,), dtype=x.dtype, device=x.device)
    return torch.cat([ones, x], dim=-1)


def tile_rows(mapped: MappedLayer, spec: MacroSpec = DEFAULT_MACRO
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Split planes into macro-row tiles [n_tiles, spec.rows, n_out], the
    last zero-padded.  Tiles are separate macros: each accumulates analog
    internally and the tile outputs combine digitally (a fan-in beyond the
    macro's rows cannot share a bit-line)."""
    rows, n_out = mapped.g_pos.shape
    n_tiles = -(-rows // spec.rows)
    pad = n_tiles * spec.rows - rows
    gp, gn = (F.pad(g, (0, 0, 0, pad)).reshape(n_tiles, spec.rows, n_out)
              for g in (mapped.g_pos, mapped.g_neg))
    return gp, gn, n_tiles


def pad_inputs_for_tiles(x_ext: torch.Tensor, n_tiles: int,
                         spec: MacroSpec = DEFAULT_MACRO) -> torch.Tensor:
    """[..., rows] -> [..., n_tiles, spec.rows], zero-padded as
    `tile_rows` pads the planes."""
    pad = n_tiles * spec.rows - x_ext.shape[-1]
    return F.pad(x_ext, (0, pad)).reshape(x_ext.shape[:-1]
                                          + (n_tiles, spec.rows))
