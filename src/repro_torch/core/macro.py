"""IRC macro specification and power model.

The paper's macro: one 1024x1024 1T1R RRAM array (TSMC 40nm embedded RRAM),
all word-lines driven simultaneously, binary current-mode SAs (TMCSA [14])
comparing differential bit-line pairs. Key measured/designed constants:

  - word-line voltage 0.44 V  (chosen at the power/accuracy kink, Fig. 14)
  - LRS cell resistance ~1e5 ohm at 0.1 V across the cell  -> ~1 uA unit current
  - HRS = non-formed cell, >1e9 ohm -> ~1e-4 unit leakage, negligible variation
  - LRS log-normal resistance sigma ~= 0.4245 (log space) at WL=0.44 V (Fig. 3)
  - max bit-line current 300 uA; SA sensing window [35 uA, 300 uA]
  - IR-drop block model: 32-cell sub-blocks along the bit-line (Sec. III-E)
  - up to 32 extra bias rows (Fig. 13b); baseline in-memory BN used 96 rows

All currents in this package are normalized to "units" of one ideal LRS cell
current at the configured word-line voltage; `i_lrs_ua` converts back to uA
for the power model and for reporting against the paper's numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# (wl_voltage, unit LRS current uA, log-normal sigma of LRS current)
# 0.44 V / sigma 0.4245 are measured (paper Figs. 3, 14). Neighbouring points
# follow the paper's Fig. 14 sweep qualitatively (sub-threshold access FET:
# current rises ~exponentially with V_WL, variation shrinks); exact
# neighbouring sigmas are not published, so this table is our documented
# stand-in fit with the measured anchor point.
WL_OPERATING_POINTS: Tuple[Tuple[float, float, float], ...] = (
    (0.38, 0.22, 0.520),
    (0.40, 0.37, 0.480),
    (0.42, 0.61, 0.450),
    (0.44, 1.00, 0.4245),   # paper's chosen point (anchor, measured)
    (0.46, 1.65, 0.395),
    (0.48, 2.72, 0.370),
    (0.50, 4.48, 0.350),
)


def wl_point(wl_voltage: float) -> Tuple[float, float]:
    """Return (unit LRS current uA, log sigma) for a word-line voltage.

    Linear interpolation between tabulated operating points.
    """
    pts = WL_OPERATING_POINTS
    if wl_voltage <= pts[0][0]:
        return pts[0][1], pts[0][2]
    if wl_voltage >= pts[-1][0]:
        return pts[-1][1], pts[-1][2]
    for (v0, i0, s0), (v1, i1, s1) in zip(pts, pts[1:]):
        if v0 <= wl_voltage <= v1:
            t = (wl_voltage - v0) / (v1 - v0)
            return i0 + t * (i1 - i0), s0 + t * (s1 - s0)
    raise AssertionError("unreachable")


@dataclasses.dataclass(frozen=True)
class MacroSpec:
    """Physical description of one IRC macro (crossbar + periphery)."""

    rows: int = 1024                 # word-lines
    cols: int = 1024                 # bit-lines (512 differential pairs)
    wl_voltage: float = 0.44         # V
    v_read: float = 0.1              # V across the 1T1R cell during read
    sense_low_ua: float = 35.0       # SA lower sensing bound (per bit-line)
    sense_high_ua: float = 300.0     # max bit-line current / SA upper bound
    ir_block: int = 32               # cells per IR-drop sub-block
    # IR-drop coefficient: fractional current loss per (unit current x block
    # segment) of cumulative wire drop.  Calibrated so ~20% LRS occupancy of a
    # full column loses ~3-5% current at the far end, reproducing the paper's
    # Fig. 10 scale and the ~2x BN-vs-no-BN current-drop gap (Fig. 16).
    ir_alpha: float = 1.5e-5
    hrs_leak: float = 1e-4           # HRS cell current, in LRS units (1e9 vs 1e5 ohm)
    bias_rows_max: int = 32          # extra-bias rows (proposed design, Fig. 13b)
    bn_rows: int = 96                # rows the baseline burns on in-memory BN
    # SA sensing-variation fit (paper Fig. 9; coefficients not published, our
    # documented stand-in): required |I+ - I-| in units for a correct decision
    # grows with the number of activated LRS cells p on the compared pair:
    #   g(p) = sa_c0 + sa_c1 * p + sa_c2 * p**2
    # anchored at ~2 units for near-empty lines, ~8 units at p=300.
    sa_c0: float = 2.0
    sa_c1: float = 0.012
    sa_c2: float = 2.2e-5
    # direct LRS-sigma override for tolerance sweeps (Table IV); None ->
    # derived from the word-line operating point
    sigma_override: float = None

    @property
    def i_lrs_ua(self) -> float:
        """Mean LRS cell current (uA) at the word-line operating point."""
        return wl_point(self.wl_voltage)[0]

    @property
    def sigma_lrs(self) -> float:
        """LRS current sigma in LRS units (override wins over WL-derived)."""
        if self.sigma_override is not None:
            return self.sigma_override
        return wl_point(self.wl_voltage)[1]

    @property
    def sense_low_units(self) -> float:
        """Lower SA sensing bound expressed in LRS-current units."""
        return self.sense_low_ua / self.i_lrs_ua

    @property
    def sense_high_units(self) -> float:
        """Upper SA sensing bound expressed in LRS-current units."""
        return self.sense_high_ua / self.i_lrs_ua

    def with_wl_voltage(self, v: float) -> "MacroSpec":
        """Copy of this spec at a different word-line voltage (Fig. 7 sweep)."""
        return dataclasses.replace(self, wl_voltage=v)

    # ---------------------------------------------------------------- power
    def read_energy_pj(self, activated_lrs: float, t_sense_ns: float = 14.6) -> float:
        """Analog read energy (pJ) of one macro evaluation.

        P = sum(I_cell) * V_read + WL driver overhead; t_sense from the TMCSA
        reference design [14] (14.6 ns parallel MAC).  This is the model used
        to reproduce the Fig. 14 power/accuracy trade-off curve.
        """
        i_total_ua = activated_lrs * self.i_lrs_ua
        p_uw = i_total_ua * self.v_read + 0.05 * self.rows * self.wl_voltage
        return p_uw * t_sense_ns * 1e-3

    def macro_grid(self, fan_in: int, fan_out: int, bias_rows: int = 0) -> Tuple[int, int]:
        """(row_tiles, col_tiles) needed to map a (fan_in x fan_out) ternary
        layer with `bias_rows` extra rows; every weight needs a differential
        column pair, so a macro holds cols//2 output channels."""
        rows_needed = fan_in + bias_rows
        row_tiles = -(-rows_needed // self.rows)
        col_tiles = -(-fan_out // (self.cols // 2))
        return row_tiles, col_tiles


DEFAULT_MACRO = MacroSpec()
