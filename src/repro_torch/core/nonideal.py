"""Nonideal-effect models of the IRC macro (paper Sec. III), on torch tensors.

Each `NonidealConfig` flag is one Table II ablation column (device
variation / nonlinearity / nonideal peripheral circuits / IR drop).  Currents
are in LRS units (1 unit = one ideal activated LRS cell); `p` is the number
of activated LRS cells on a bit-line.  Random draws consume only the explicit
key passed in (`repro_torch.prng`), with the reference's split discipline.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch import xla_order as xo
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO


@dataclasses.dataclass(frozen=True)
class NonidealConfig:
    """Which nonideal effects to simulate (Table II columns)."""

    device_variation: bool = False
    nonlinearity: bool = False
    sa_variation: bool = False       # "nonideal peripheral circuits" (1/2)
    sensing_range: bool = False      # "nonideal peripheral circuits" (2/2)
    ir_drop: bool = False

    @classmethod
    def none(cls) -> "NonidealConfig":
        """Ideal crossbar: every effect disabled."""
        return cls()

    @classmethod
    def all(cls) -> "NonidealConfig":
        """All five effects enabled (Table II "all nonideal" column)."""
        return cls(device_variation=True, nonlinearity=True, sa_variation=True,
                   sensing_range=True, ir_drop=True)

    def any(self) -> bool:
        """True when at least one effect is enabled."""
        return (self.device_variation or self.nonlinearity or self.sa_variation
                or self.sensing_range or self.ir_drop)


# ------------------------------------------------------------------ device variation

def sample_variation_mask(key: torch.Tensor, shape, sigma: float
                          ) -> torch.Tensor:
    """Per-cell log-normal current mask exp(sigma * z), median 1 (Fig. 3).
    Key batch axes lead the result.  Rounded as the reference's jitted
    sampling rounds it: sigma folded into the normal's constant sqrt(2),
    XLA's exp (`prng.lognormal`: one launch of the threefry kernel on the
    card)."""
    return prng.lognormal(key, shape, sigma)


# ------------------------------------------------------------------ nonlinearity

# Piecewise quartic fit of the accumulated bit-line current ratio vs the
# number of activated LRS cells p (Sec. III-C, exact published coefficients).
_NL_LO = (1.0286e-8, -3.79e-6, 5.3e-4, -3.92e-2, 2.5)        # p <= 140
_NL_HI = (1.8063e-11, -3.204e-8, 2.2495e-5, -8.057e-3, 1.707)  # p > 140


def _horner(p: torch.Tensor, coeffs) -> torch.Tensor:
    # each step one fused multiply-add, as XLA contracts the reference's
    acc = torch.full_like(p, coeffs[0])
    for c in coeffs[1:]:
        acc = xo.fma(acc, p, c)
    return acc


def nonlinearity_ratio(p: torch.Tensor) -> torch.Tensor:
    """ratio(p) = accumulated / ideal current for p activated LRS cells;
    1 for an empty line, p clamped to the fit domain [0, 320]."""
    p_raw = p.float()
    p = torch.clamp(p_raw, 0.0, 320.0)
    ratio = torch.where(p <= 140.0, _horner(p, _NL_LO), _horner(p, _NL_HI))
    return torch.where(p_raw < 0.5, torch.ones_like(ratio), ratio)


def apply_nonlinearity(i_ideal: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Distort an accumulated bit-line current given its activated-LRS count."""
    return i_ideal * nonlinearity_ratio(p)


# ------------------------------------------------------------------ IR drop

def ir_drop_factors(block_currents: torch.Tensor, alpha: float,
                    axis: int = -1) -> torch.Tensor:
    """Per-block current-retention factors clip(1 - alpha * cum_b, 0, 1)
    along a bit-line, block 0 nearest the driver, with the cumulative wire
    drop cum_b = sum_j min(b, j) * I_j written as one min-matrix contraction
    (the reference's formulation; exact in real arithmetic to the
    suffix-cumsum chain the kernels use).  On the CPU torch's matmul adds
    the contraction in XLA's order (sequential fused multiply-adds over j),
    and 1 - alpha * cum is one fused multiply-add, as XLA contracts it
    (`tests/test_torch_sum_order.py`)."""
    nb = block_currents.shape[axis]
    idx = torch.arange(nb, dtype=torch.float32, device=block_currents.device)
    w_min = torch.minimum(idx[:, None], idx[None, :])       # [j, b]
    moved = torch.movedim(block_currents, axis, -1)
    cum = torch.movedim(moved @ w_min, -1, axis)
    return torch.clamp(xo.fma(-alpha, cum, 1.0), 0.0, 1.0)


def apply_ir_drop(block_currents: torch.Tensor, alpha: float
                  ) -> torch.Tensor:
    """Total bit-line current after IR drop from per-block ideal currents
    [..., nb]: sum_b I_b * factor_b, sequential over b with each step one
    fused multiply-add, as XLA adds the reference's `jnp.sum(blocks *
    factors, axis=-1)`.  (The factors' contraction over the minor axis is
    torch's matmul here and a library matmul in XLA, whose order changes
    with nb: they agree to a few ulps.)"""
    return xo.seq_fma_sum(block_currents,
                          ir_drop_factors(block_currents, alpha), -1)


# ------------------------------------------------------------------ SA periphery

def sa_required_diff(p: torch.Tensor, spec: MacroSpec = DEFAULT_MACRO
                     ) -> torch.Tensor:
    """Required |I+ - I-| (units) for a correct SA decision vs activated LRS
    count p on the compared pair (Fig. 9)."""
    p = p.float()
    return xo.fma(spec.sa_c2 * p, p, xo.fma(spec.sa_c1, p, spec.sa_c0))


def _device_or_analytic(device):
    """Resolve the `device=` seam: None -> the analytic singleton."""
    if device is None:
        from repro_torch.device.analytic import ANALYTIC_DEVICE
        return ANALYTIC_DEVICE
    return device


def sa_offset(key: torch.Tensor, p: torch.Tensor,
              spec: MacroSpec = DEFAULT_MACRO, extra_units: float = 0.0,
              device=None) -> torch.Tensor:
    """Random input-referred SA offset current (units): zero-mean Gaussian
    with the device model's sigma at activated-LRS count p (analytic: half
    the required difference g(p), + `extra_units`).  `key` is one key or a
    batch [..., 2] whose axes lead p, as in `resolve_sa`."""
    sigma = _device_or_analytic(device).sa_offset_sigma(p, spec, extra_units)
    return sigma * prng.normal(key, p.shape[key.ndim - 1:])


def sensing_failure(i_pos: torch.Tensor, i_neg: torch.Tensor,
                    spec: MacroSpec = DEFAULT_MACRO) -> torch.Tensor:
    """Boolean mask of comparisons outside the SA sensing window (Sec. III-D)."""
    too_low = torch.minimum(i_pos, i_neg) < spec.sense_low_units
    too_high = torch.maximum(i_pos, i_neg) > spec.sense_high_units
    return too_low | too_high


def resolve_sa(key: torch.Tensor, i_pos: torch.Tensor, i_neg: torch.Tensor,
               p_total: torch.Tensor, cfg: NonidealConfig,
               spec: MacroSpec = DEFAULT_MACRO, sa_extra_units: float = 0.0,
               device=None) -> torch.Tensor:
    """Binary SA decision in {0,1}: 1 iff (I+ - I- + offset) > 0, with
    out-of-range comparisons replaced by random bits.  The offset is
    zero-mean Gaussian with the device model's sigma (analytic: half the
    required difference g(p)).  `key` is one key ([2]) or a batch [..., 2]
    whose axes lead i_pos (a chip per key); each key draws the shape of
    i_pos's remaining axes.  p_total broadcasts against i_pos."""
    ks = prng.split(key)
    k_off, k_rng = ks[..., 0, :], ks[..., 1, :]
    shape = i_pos.shape[key.ndim - 1:]
    diff = i_pos - i_neg
    if cfg.sa_variation:
        sigma = _device_or_analytic(device).sa_offset_sigma(
            p_total, spec, sa_extra_units)
        diff = xo.fma(sigma, prng.normal(k_off, shape), diff)
    out = (diff > 0).float()
    if cfg.sensing_range:
        fail = sensing_failure(i_pos, i_neg, spec)
        rnd = prng.bernoulli(k_rng, 0.5, shape)
        out = torch.where(fail, rnd, out)
    return out


def sensed_diff(key: torch.Tensor, i_pos: torch.Tensor, i_neg: torch.Tensor,
                p_total: torch.Tensor, cfg: NonidealConfig,
                spec: MacroSpec = DEFAULT_MACRO, sa_extra_units: float = 0.0,
                device=None) -> torch.Tensor:
    """The analog difference ONE macro's periphery reports to a digital
    combiner (multi-tile layers: each tile has its own SA front-end).

    Same key discipline and effects as `resolve_sa`: the SA offset is an
    additive input-referred current, and an out-of-range comparison reads
    as a random-sign current at the just-resolvable magnitude 2 sigma (g(p)
    + extra for the analytic periphery), so thresholding one tile's sensed
    difference at zero gives `resolve_sa`'s decisions bit for bit."""
    ks = prng.split(key)
    k_off, k_rng = ks[..., 0, :], ks[..., 1, :]
    shape = i_pos.shape[key.ndim - 1:]
    diff = i_pos - i_neg
    dev = _device_or_analytic(device)
    if cfg.sa_variation:
        sigma = dev.sa_offset_sigma(p_total, spec, sa_extra_units)
        diff = xo.fma(sigma, prng.normal(k_off, shape), diff)
    if cfg.sensing_range:
        fail = sensing_failure(i_pos, i_neg, spec)
        rnd = prng.bernoulli(k_rng, 0.5, shape)
        mag = 2.0 * dev.sa_offset_sigma(p_total, spec, sa_extra_units)
        diff = torch.where(fail, torch.where(rnd > 0, mag, -mag), diff)
    return diff
