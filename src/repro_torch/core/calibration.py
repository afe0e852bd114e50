"""Layerwise extra-bias calibration (paper Sec. IV-B.4, Table I).

The extra common-mode bias rows lift `min(I+, I-)` above the SA's lower
sensing bound, but more always-on LRS cells also enlarge the SA's
input-referred offset (Fig. 9), so the bias is a per-layer trade-off.
`calibrate_bias` sweeps candidate biases against a calibration batch of
bit-line current pairs and keeps the one with the least total expected
error rate, from Table I's components:

    sensing-variation errors : |I+ - I-| too small for the offset at p_pair
    below-lower-bound errors : min(I+, I-) + bias < sense_low
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO


def sa_error_rates(i_pos: torch.Tensor, i_neg: torch.Tensor,
                   p_pair: torch.Tensor, bias_units: float,
                   spec: MacroSpec = DEFAULT_MACRO
                   ) -> Dict[str, torch.Tensor]:
    """Expected error components for one candidate bias, as scalar rates
    in [0, 1] (analytic expectations, no sampling).

    i_pos/i_neg: calibration-batch bit-line currents without the bias;
    p_pair: activated LRS count on the pair (the bias adds 2 * bias_units).
    `sensing_variation` is P(the Gaussian offset, std 0.5 * g(p), flips the
    decision); `below_lower_bound` / `above_upper_bound` the fractions
    outside the sensing window."""
    b = float(bias_units)
    ip, in_ = i_pos + b, i_neg + b
    p = p_pair + 2.0 * b
    diff = torch.abs(ip - in_)
    sigma = 0.5 * ni.sa_required_diff(p, spec)
    # P(|N(0, sigma)| > diff) = 2 * (1 - Phi(diff / sigma))
    flip = 2.0 * (1.0 - torch.special.ndtr(diff / torch.clamp(sigma,
                                                              min=1e-9)))
    low = (torch.minimum(ip, in_) < spec.sense_low_units).float()
    high = (torch.maximum(ip, in_) > spec.sense_high_units).float()
    return {"sensing_variation": torch.mean(flip),
            "below_lower_bound": torch.mean(low),
            "above_upper_bound": torch.mean(high)}


def calibrate_bias(i_pos: torch.Tensor, i_neg: torch.Tensor,
                   p_pair: torch.Tensor, spec: MacroSpec = DEFAULT_MACRO,
                   candidates: Sequence[int] = (0, 4, 8, 12, 16, 20, 24, 28,
                                                32),
                   ) -> Tuple[int, Dict[int, Dict[str, float]]]:
    """The bias (LRS units, <= spec.bias_rows_max) with the least total
    error rate on a calibration batch; returns (best_bias, report), the
    report holding each candidate's Table-I-style components and total.
    Candidates above `spec.bias_rows_max` are skipped."""
    report: Dict[int, Dict[str, float]] = {}
    best, best_err = 0, float("inf")
    for b in candidates:
        if b > spec.bias_rows_max:
            continue
        rates = {k: float(v) for k, v in
                 sa_error_rates(i_pos, i_neg, p_pair, float(b), spec).items()}
        total = sum(rates.values())
        report[b] = dict(rates, total=total)
        if total < best_err:
            best, best_err = b, total
    return best, report


def layer_current_stats(key: torch.Tensor, x_bits: torch.Tensor, mapped,
                        spec: MacroSpec = DEFAULT_MACRO
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i_pos, i_neg, p_pair), each flattened, for a calibration batch
    through one mapped layer with device variation and IR drop on (the
    physical effects present when the SA samples the lines) and no
    periphery model.  The masks are the analytic log-normal ones at the
    spec's sigma, drawn from `split(key)` directly (not through a device
    model), as the reference draws them."""
    from repro_torch import prng
    from repro_torch.core.crossbar import _accumulate, _block_reduce
    from repro_torch.core.mapping import extend_inputs
    cfg = ni.NonidealConfig(device_variation=True, ir_drop=True)
    ks = prng.split(key)
    x_ext = extend_inputs(x_bits, mapped)
    gp, gn = mapped.g_pos, mapped.g_neg
    ep = gp * ni.sample_variation_mask(ks[..., 0, :], gp.shape,
                                       spec.sigma_lrs)
    en = gn * ni.sample_variation_mask(ks[..., 1, :], gn.shape,
                                       spec.sigma_lrs)
    blk = spec.ir_block
    i_pos, p_pos = _accumulate(_block_reduce(x_ext, ep, blk),
                               _block_reduce(x_ext, gp, blk),
                               cfg, spec, "single_shot", 256)
    i_neg, p_neg = _accumulate(_block_reduce(x_ext, en, blk),
                               _block_reduce(x_ext, gn, blk),
                               cfg, spec, "single_shot", 256)
    return i_pos.reshape(-1), i_neg.reshape(-1), (p_pos + p_neg).reshape(-1)
