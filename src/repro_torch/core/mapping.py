"""Weight -> crossbar conductance-plane mapping (paper Sec. IV-B, Fig. 13b).

`ternary_planes` (proposed design): each weight column maps to a
differential (G+, G-) bit-line pair; +1 -> (LRS, HRS), -1 -> (HRS, LRS),
0 -> (HRS, HRS).  Row 0 is nearest the bit-line driver, and the <= 32 extra
bias rows sit there.  The baseline's binary mapping comes with the baseline
design in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MappedLayer:
    """A linear layer mapped onto crossbar conductance planes.

    g_pos/g_neg: [rows_mapped, n_out] float {0,1}, row 0 nearest the driver;
    the `bias_rows` leading rows are always-on common-mode bias (LRS on both
    planes)."""
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
