"""Plain PyTorch reference of one IRC macro and of its dies, written from
the paper's model (Sec. III-IV) and the configuration's constants, with no
code of the program under test.

A die of a mapped layer is sampled from its key k: split(k, 3) gives the
positive plane's variation key, the negative plane's and the SA key.  An
LRS cell's current is its log-normal variation factor (or the measured
table's inverse CDF, aged by retention drift), an HRS cell's the leak.
One evaluation of word lines x (bias rows first, always on):

  block currents  I_b = sum over the 32 rows of block b of x e
  IR drop         cum_b = sum_j min(b, j) I_j,
                  factor_b = clip(1 - alpha cum_b, 0, 1),
                  line current = sum_b I_b factor_b
  nonlinearity    line current x ratio(p), p the activated LRS count
                  (x . g), the published piecewise quartic
  SA              diff = I+ - I- + sigma(p+ + p-) eps,
                  sigma = (c0 + c1 p + c2 p^2) / 2, bit = diff > 0
  sensing range   a line outside [low, high] gives a fair coin instead

eps and the coins are the SA key's per-read draws: split(k_sa) gives the
offsets' key and the coins', each a draw of shape (rows of x, outputs).

Every matrix product goes through `mm`, so the control can run the same
reference at TF32's precision (`precision="tf32"`: both operands rounded
to 10 mantissa bits, float32 accumulation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import threefry as tf

_NL_LO = (1.0286e-8, -3.79e-6, 5.3e-4, -3.92e-2, 2.5)        # p <= 140
_NL_HI = (1.8063e-11, -3.204e-8, 2.2495e-5, -8.057e-3, 1.707)  # p > 140
#: float32 rows of word lines evaluated at once
ROW_BLOCK = 65536


@dataclasses.dataclass(frozen=True)
class Macro:
    """The macro's constants in LRS-current units (a configuration file's
    "macro" group)."""
    ir_block: int
    ir_alpha: float
    sense_low: float
    sense_high: float
    sa_c0: float
    sa_c1: float
    sa_c2: float
    sigma_lrs: float
    hrs_leak: float

    @classmethod
    def from_config(cls, macro: Dict) -> "Macro":
        """From a configuration's "macro" group (currents in uA there)."""
        i_lrs = float(macro["i_lrs_ua"])
        return cls(ir_block=int(macro["ir_block"]),
                   ir_alpha=float(macro["ir_alpha"]),
                   sense_low=float(macro["sense_low_ua"]) / i_lrs,
                   sense_high=float(macro["sense_high_ua"]) / i_lrs,
                   sa_c0=float(macro["sa_c0"]), sa_c1=float(macro["sa_c1"]),
                   sa_c2=float(macro["sa_c2"]),
                   sigma_lrs=float(macro["sigma_lrs"]),
                   hrs_leak=float(macro["hrs_leak"]))


@dataclasses.dataclass(frozen=True)
class Effects:
    """Which nonideal effects are on (a Table II column)."""
    device_variation: bool = True
    nonlinearity: bool = True
    sa_variation: bool = True
    sensing_range: bool = True
    ir_drop: bool = True

    @classmethod
    def column(cls, name: str) -> "Effects":
        """A Table II column by its name."""
        cols = {"ideal": cls(False, False, False, False, False),
                "devvar": cls(True, False, False, False, False),
                "devvar+nl": cls(True, True, False, False, False),
                "devvar+nl+peri": cls(True, True, True, True, False),
                "all": cls()}
        return cols[name]


@dataclasses.dataclass(frozen=True)
class Device:
    """Where LRS variation comes from: the analytic log-normal at the
    macro's sigma, or a measured quantile table (xp, fp), either aged by
    retention drift at `t_days` (decay (1 + t/t0)^-nu, spread
    spread_rate log1p(t/t0), drawn under fold_in(k, salt))."""
    table: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    leak: Optional[float] = None
    t_days: float = 0.0
    t0_days: float = 1.0
    drift_nu: float = 0.05
    spread_rate: float = 0.02
    drift_salt: int = 0x0D21F7

    @classmethod
    def from_traffic(cls, d: Optional[Dict]) -> "Device":
        """From a mix's "device" group (None: analytic at day 0)."""
        if not d or d.get("model", "analytic") == "analytic":
            return cls(t_days=float((d or {}).get("t_days", 0.0)))
        data = d["data"]
        iv = data["iv"]
        v_read = float(d["v_read"])
        leak = (float(np.interp(v_read, iv["v"], iv["i_hrs_ua"]))
                / float(np.interp(v_read, iv["v"], iv["i_lrs_ua"])))
        table = (tuple(data["variation"]["quantile"]),
                 tuple(data["variation"]["factor"]))
        return cls(table=table, leak=leak, t_days=float(d.get("t_days", 0.0)))

    def mask(self, k: torch.Tensor, shape: Sequence[int],
             sigma: float) -> torch.Tensor:
        """Per-cell LRS current factors [..., *shape] of the dies keyed k."""
        if self.table is None:
            m = tf.lognormal(k, shape, sigma)
        else:
            m = tf.measured(k, shape, *self.table)
        if self.t_days == 0.0:
            return m
        decay = (1.0 + self.t_days / self.t0_days) ** (-self.drift_nu)
        spread = self.spread_rate * float(np.log1p(self.t_days / self.t0_days))
        drift = tf.lognormal(tf.fold_in(k, self.drift_salt), shape, spread)
        return m * (float(np.float32(decay)) * drift)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0xFFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, or at TF32's precision."""
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def scheme(cfg: Dict) -> Tuple[float, float]:
    """A configuration's (low, high) ternary fractions; raises where it
    asks for a threefry counter scheme other than the partitionable one,
    the only one `threefry` implements."""
    if cfg["threefry"] != "partitionable":
        raise ValueError(f"threefry scheme {cfg['threefry']!r} is not "
                         f"implemented")
    lo, _, hi = (float(f) for f in cfg["ternary_fractions"])
    return lo, hi


def ternary_map(w: torch.Tensor, lo_frac: float = 0.2,
                hi_frac: float = 0.2) -> torch.Tensor:
    """Quantile-regulated ternary weights of `w` over all its elements:
    -1 at or below the lo_frac quantile, +1 at or above the 1 - hi_frac
    quantile, 0 between; the k-th smallest, k = int(frac (n - 1) + 0.5)."""
    ws = torch.sort(w.reshape(-1)).values
    n = ws.numel()
    t_lo = ws[min(int(lo_frac * (n - 1) + 0.5), n - 1)]
    t_hi = ws[min(int((1.0 - hi_frac) * (n - 1) + 0.5), n - 1)]
    return torch.where(w <= t_lo, -1.0, torch.where(w >= t_hi, 1.0, 0.0))


def planes(w_t: torch.Tensor, bias_rows: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differential {0,1} placement planes of ternary weights [K, N]: +1 is
    LRS on the positive line, -1 on the negative, the bias rows LRS on
    both; [bias_rows + K, N] each."""
    ones = torch.ones((bias_rows, w_t.shape[1]), device=w_t.device)
    return (torch.cat([ones, (w_t > 0.5).float()]),
            torch.cat([ones, (w_t < -0.5).float()]))


def sample_dies(keys: torch.Tensor, gp: torch.Tensor, gn: torch.Tensor,
                macro: Macro, effects: Effects, device: Device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Effective conductances (ep, en) [C, R, N] and SA keys [C, 2] of the
    dies keyed `keys` [C, 2]."""
    ks = tf.split(keys, 3)
    leak = macro.hrs_leak if device.leak is None else device.leak
    shape = tuple(gp.shape)
    if effects.device_variation:
        ep = gp * device.mask(ks[:, 0], shape, macro.sigma_lrs)
        en = gn * device.mask(ks[:, 1], shape, macro.sigma_lrs)
    else:
        ep = gp.expand((keys.shape[0],) + shape)
        en = gn.expand((keys.shape[0],) + shape)
    ep = ep + (1.0 - gp) * leak
    en = en + (1.0 - gn) * leak
    return ep, en, ks[:, 2]


def nl_ratio(p: torch.Tensor) -> torch.Tensor:
    """Accumulated / ideal current at p activated LRS cells; 1 for an
    empty line, p clamped to the fit's domain [0, 320]."""
    q = torch.clamp(p, 0.0, 320.0).double()
    def horner(c):
        acc = torch.full_like(q, c[0])
        for x in c[1:]:
            acc = acc * q + x
        return acc
    r = torch.where(q <= 140.0, horner(_NL_LO), horner(_NL_HI)).float()
    return torch.where(p < 0.5, torch.ones_like(r), r)


def _line(x: torch.Tensor, e: torch.Tensor, macro: Macro, ir: bool,
          precision: str) -> torch.Tensor:
    """Line currents [M, N] of word lines x [M, R] on plane e [R, N]."""
    blk = macro.ir_block
    pad = (-x.shape[1]) % blk
    if pad:
        x = F.pad(x, (0, pad))
        e = F.pad(e, (0, 0, 0, pad))
    nb = x.shape[1] // blk
    xb = x.reshape(x.shape[0], nb, blk).transpose(0, 1)     # [nb, M, blk]
    blocks = mm(xb, e.reshape(nb, blk, -1), precision)      # [nb, M, N]
    if not ir:
        return blocks.sum(0)
    idx = torch.arange(nb, dtype=torch.float32, device=x.device)
    w_min = torch.minimum(idx[:, None], idx[None, :])       # [j, b]
    cum = mm(blocks.permute(1, 2, 0), w_min, precision)     # [M, N, nb]
    factor = torch.clamp(1.0 - macro.ir_alpha * cum, 0.0, 1.0)
    return (blocks.permute(1, 2, 0) * factor).sum(-1)


def evaluate(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
             gp: torch.Tensor, gn: torch.Tensor, k_sa: torch.Tensor,
             row0: int, macro: Macro, effects: Effects,
             precision: str = "float32") -> torch.Tensor:
    """SA bits [M, N] of one die on word lines x [M, R] (bias rows
    included), rows row0..row0+M-1 of the die's per-read draws."""
    out = []
    n_out = ep.shape[1]
    k_off, k_rng = tf.split(k_sa, 2)
    for lo in range(0, x.shape[0], ROW_BLOCK):
        xs = x[lo:lo + ROW_BLOCK]
        m = xs.shape[0]
        i_pos = _line(xs, ep, macro, effects.ir_drop, precision)
        i_neg = _line(xs, en, macro, effects.ir_drop, precision)
        p_pos = mm(xs, gp, "float32")
        p_neg = mm(xs, gn, "float32")
        if effects.nonlinearity:
            i_pos = i_pos * nl_ratio(p_pos)
            i_neg = i_neg * nl_ratio(p_neg)
        diff = i_pos - i_neg
        a, b = (row0 + lo) * n_out, (row0 + lo + m) * n_out
        if effects.sa_variation:
            p = p_pos + p_neg
            sigma = 0.5 * (macro.sa_c0 + macro.sa_c1 * p + macro.sa_c2 * p * p)
            diff = diff + sigma * tf.normal(k_off, a, b).reshape(m, n_out)
        bits = (diff > 0).float()
        if effects.sensing_range:
            fail = ((torch.minimum(i_pos, i_neg) < macro.sense_low)
                    | (torch.maximum(i_pos, i_neg) > macro.sense_high))
            coins = tf.bernoulli_half(k_rng, a, b).reshape(m, n_out)
            bits = torch.where(fail, coins, bits)
        out.append(bits)
    return torch.cat(out)
