"""Structural crossbar simulation of one IRC macro (the paper's core).

`crossbar_forward` samples one chip (`sample_chip_planes`: per-cell device
variation and HRS leak, drawn once per die) and runs it (`crossbar_apply`:
32-cell IR-drop blocks, the accumulation nonlinearity, SA offset and
limited sensing range).  It is the single-chip plain path that the chip
ensembles and the fused kernel are held against.

Accumulation modes (Sec. III-C / IV-B.3): "single_shot" (proposed) sums the
whole column in one analog step; "partial_sum" (baseline) splits it into
`partial_rows`-row chunks summed digitally, each with its own
nonlinearity.  `ideal_ternary_matmul` is the ideal digital reference,
through the ternary matmul kernel on the card.  Its "sensed_diff" readout
is what one macro's periphery reports to a digital combiner: `IRCLinear`
tiles a fan-in wider than one macro over several, sums their sensed
differences and thresholds the sum.

QAT surrogate: `irc_linear_train` is the differentiable layer (STE
quantizers, a plain matmul) with the structural sim's noise to first order
(`variation_noise_std`, the SA's required difference) drawn fresh per step;
`add_noise` adds such a draw as the reference's jitted step rounds it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch import xla_order as xo
from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import MappedLayer, extend_inputs
from repro_torch.core.ternary import (binary_activation, binary_quantize,
                                     soft_sa_output, ternary_quantize)
from repro_torch.kernels import ops


def _block_reduce(x_ext: torch.Tensor, plane: torch.Tensor, block: int
                  ) -> torch.Tensor:
    """Per-IR-block partial currents: x_ext [..., R], plane [R, N]
    -> [..., nb, N] with nb = ceil(R / block) (zero rows at the far end).
    A chip batch of planes [C, R, N] takes x_ext [B, R] shared by every
    chip or [C, B, R] per chip and gives [C, B, nb, N]."""
    rows, n_out = plane.shape[-2:]
    nb = -(-rows // block)
    pad = nb * block - rows
    if pad:
        x_ext = F.pad(x_ext, (0, pad))
        plane = F.pad(plane, (0, 0, 0, pad))
    xb = x_ext.reshape(x_ext.shape[:-1] + (nb, block))
    pb = plane.reshape(plane.shape[:-2] + (nb, block, n_out))
    if plane.ndim == 2:
        return torch.einsum("...bk,bkn->...bn", xb, pb)
    return (xb.transpose(-3, -2) @ pb).transpose(-3, -2)


def _weighted_block_sum(blocks: torch.Tensor, factors, dim: int
                        ) -> torch.Tensor:
    """sum over `dim` of blocks (times the IR-drop factors, if any), in the
    reference's order: sequential, each weighted step one fused
    multiply-add."""
    if factors is None:
        return xo.seq_sum(blocks, dim)
    return xo.seq_fma_sum(blocks, factors, dim)


def _accumulate(blocks: torch.Tensor, counts: torch.Tensor,
                cfg: ni.NonidealConfig, spec: MacroSpec, accumulation: str,
                partial_rows: int, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IR drop + nonlinearity on per-block currents [..., nb, N] with their
    activated-LRS counts (leading axes broadcast against the currents');
    returns (bit-line current, activated LRS count), each [..., N].
    "partial_sum" sums `partial_rows // ir_block` blocks per chunk (the last
    chunk zero-padded) and applies the nonlinearity per chunk.

    Every sum runs in the reference's float32 order (`repro_torch.xla_order`):
    sequential over blocks, the IR-drop weighting fused into each step.
    Without the nonlinearity, XLA folds the reference's chunk sums and the
    sum over chunks into one reduction over every block, so the partial-sum
    line current is then the single-shot one."""
    factors = (ni._device_or_analytic(device).ir_drop_factors(
        blocks, spec, axis=-2) if cfg.ir_drop else None)
    p_total = xo.seq_sum(counts, -2)
    if accumulation not in ("single_shot", "partial_sum"):
        raise ValueError(f"unknown accumulation mode: {accumulation!r}")
    if not cfg.nonlinearity:
        return _weighted_block_sum(blocks, factors, -2), p_total
    if accumulation == "single_shot":
        i_line = _weighted_block_sum(blocks, factors, -2)
        return ni.apply_nonlinearity(i_line, p_total), p_total
    nb, n_out = blocks.shape[-2:]
    chunk = max(1, partial_rows // spec.ir_block)
    n_chunks = -(-nb // chunk)
    pad = n_chunks * chunk - nb

    def chunked(t):
        if pad:
            t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(t.shape[:-2] + (n_chunks, chunk, n_out))

    i_chunk = _weighted_block_sum(
        chunked(blocks), None if factors is None else chunked(factors), -2)
    p_chunk = xo.seq_sum(chunked(counts), -2)
    i_line = xo.seq_fma_sum(i_chunk, ni.nonlinearity_ratio(p_chunk), -2)
    return i_line, p_total


def sample_chip_planes(key: torch.Tensor, g_pos: torch.Tensor,
                       g_neg: torch.Tensor, scheme: str,
                       cfg: ni.NonidealConfig,
                       spec: MacroSpec = DEFAULT_MACRO, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample chip instances: (ep, en, k_sa) from key(s) [..., 2].

    The key splits into 3 (positive-plane mask, negative-plane mask, SA key)
    as in the reference, so chip identity matches it bit for bit.  Key batch
    axes lead ep/en ([chips, R, N] from [chips, 2] keys) and k_sa.  The
    baseline ("binary") has ONE physical reference line: its variation mask
    is drawn [rows, 1] from the same split key and is common to every
    output column."""
    if scheme not in ("ternary", "binary"):
        raise ValueError(f"unknown mapping scheme: {scheme!r}")
    dev = ni._device_or_analytic(device)
    ks = prng.split(key, 3)
    k_var_p, k_var_n, k_sa = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
    lead = key.shape[:-1]
    ep = g_pos.expand(lead + g_pos.shape)
    en = g_neg.expand(lead + g_neg.shape)
    if cfg.device_variation:
        ep = g_pos * dev.variation_mask(k_var_p, g_pos.shape, spec)
        n_shape = ((g_neg.shape[0], 1) if scheme == "binary"
                   else g_neg.shape)
        en = g_neg * dev.variation_mask(k_var_n, n_shape, spec)
    leak = dev.hrs_leak_units(spec)
    if leak:
        ep = ep + (1.0 - g_pos) * leak
        en = en + (1.0 - g_neg) * leak
    return ep.contiguous(), en.contiguous(), k_sa


def crossbar_apply(k_sa: torch.Tensor, x_ext: torch.Tensor,
                   ep: torch.Tensor, en: torch.Tensor,
                   gp: torch.Tensor, gn: torch.Tensor, *,
                   cfg: ni.NonidealConfig = ni.NonidealConfig.none(),
                   spec: MacroSpec = DEFAULT_MACRO,
                   accumulation: str = "single_shot",
                   partial_rows: int = 256,
                   sa_extra_units: float = 0.0,
                   output: str = "binary", device=None) -> torch.Tensor:
    """Forward through ONE sampled chip: x_ext [..., rows] (bias rows
    prefixed), ep/en effective planes, gp/gn placement planes.
    output="binary" gives SA decisions, "diff" the analog difference,
    "sensed_diff" the difference the periphery reports (SA offset and
    sensing-range failures applied, `ni.sensed_diff`)."""
    blk = spec.ir_block
    i_pos, p_pos = _accumulate(_block_reduce(x_ext, ep, blk),
                               _block_reduce(x_ext, gp, blk),
                               cfg, spec, accumulation, partial_rows, device)
    i_neg, p_neg = _accumulate(_block_reduce(x_ext, en, blk),
                               _block_reduce(x_ext, gn, blk),
                               cfg, spec, accumulation, partial_rows, device)
    if output == "diff":
        return i_pos - i_neg
    if output == "sensed_diff":
        return ni.sensed_diff(k_sa, i_pos, i_neg, p_pos + p_neg, cfg, spec,
                              sa_extra_units, device)
    if output != "binary":
        raise ValueError(f"unknown output {output!r}")
    return ni.resolve_sa(k_sa, i_pos, i_neg, p_pos + p_neg, cfg, spec,
                         sa_extra_units, device)


def crossbar_forward(key: torch.Tensor, x_bits: torch.Tensor,
                     mapped: MappedLayer, *,
                     cfg: ni.NonidealConfig = ni.NonidealConfig.none(),
                     spec: MacroSpec = DEFAULT_MACRO,
                     accumulation: str = "single_shot",
                     partial_rows: int = 256,
                     sa_extra_units: float = 0.0,
                     output: str = "binary", device=None) -> torch.Tensor:
    """Sample one chip from `key` ([2]) and run x_bits [..., fan_in] through
    it; returns [..., n_out]."""
    assert mapped.rows <= spec.rows, (
        f"planes ({mapped.rows} rows) exceed the macro ({spec.rows}); tile first")
    ep, en, k_sa = sample_chip_planes(key, mapped.g_pos, mapped.g_neg,
                                      mapped.scheme, cfg, spec, device)
    x_ext = extend_inputs(x_bits, mapped)
    return crossbar_apply(k_sa, x_ext, ep, en, mapped.g_pos, mapped.g_neg,
                          cfg=cfg, spec=spec, accumulation=accumulation,
                          partial_rows=partial_rows,
                          sa_extra_units=sa_extra_units, output=output,
                          device=device)


def ideal_ternary_matmul(x_bits: torch.Tensor, w_t: torch.Tensor
                         ) -> torch.Tensor:
    """Ideal digital reference: {0,1} inputs [B, K] x ternary weights
    [K, N] -> [B, N] float32, through the ternary matmul kernel on the card.
    Raises ValueError on a weight outside {-1, 0, +1}, which the int8
    weight operand could not carry."""
    if not bool(((w_t == 0) | (w_t.abs() == 1)).all()):
        raise ValueError("ideal_ternary_matmul needs weights in {-1, 0, +1}")
    return ops.ternary_matmul(x_bits.float(), w_t.to(torch.int8))


# ------------------------------------------------------------------ QAT surrogate

def variation_noise_std(p: torch.Tensor, sigma: float) -> torch.Tensor:
    """First-order std of a p-cell accumulated current under per-cell
    log-normal variation: sqrt(max(p, 0) * (e^s2 - 1) e^s2), s2 = sigma^2,
    the cell variance a float32 constant."""
    e = np.exp(np.float32(sigma * sigma))
    cell_var = float((e - np.float32(1.0)) * e)
    return xo.sqrt(torch.clamp(p, min=0.0) * cell_var)


class _AddNoise(torch.autograd.Function):
    """pre + std * eps rounded once, as XLA contracts it inside the
    reference's jitted step; the gradient passes to `pre` alone (std and
    eps carry none)."""

    @staticmethod
    def forward(ctx, pre, std, eps):
        return xo.fma(std, eps, pre)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def add_noise(pre: torch.Tensor, std: torch.Tensor, eps: torch.Tensor
              ) -> torch.Tensor:
    """pre + std * eps (std and eps broadcast to pre's shape) in one
    fused multiply-add, differentiable in `pre`."""
    return _AddNoise.apply(pre, std.detach(), eps.detach())


def irc_linear_train(key: torch.Tensor, x: torch.Tensor,
                     w_latent: torch.Tensor, *,
                     cfg: ni.NonidealConfig = ni.NonidealConfig.none(),
                     spec: MacroSpec = DEFAULT_MACRO,
                     scheme: str = "ternary", binarize_input: bool = True,
                     sa_beta: float = 4.0, output: str = "binary"
                     ) -> torch.Tensor:
    """Differentiable QAT layer: quantized matmul plus reparametrized
    noise.  The current-difference noise from device variation has std
    sqrt(p_pair) * std_cell and the SA offset std 0.5 * g(p_pair), p_pair
    the expected activated-LRS count; both are added to the pre-activation
    with a fresh draw keyed `split(key)[0]`.  output="diff" returns the
    pre-activation, "binary" the SA surrogate `soft_sa_output`."""
    if binarize_input:
        x = binary_activation(x)
    if scheme == "ternary":
        w_q = ternary_quantize(w_latent)
    elif scheme == "binary":
        w_q = binary_quantize(w_latent)
    else:
        raise ValueError(scheme)
    pre = x @ w_q
    if cfg.device_variation or cfg.sa_variation:
        k1 = prng.split(key)[0]
        lrs_frac = torch.mean(torch.abs(w_q.detach()))
        p_pair = torch.sum(x.detach(), dim=-1, keepdim=True) * lrs_frac
        std = 0.0
        if cfg.device_variation:
            std = std + variation_noise_std(p_pair, spec.sigma_lrs)
        if cfg.sa_variation:
            std = std + 0.5 * ni.sa_required_diff(p_pair, spec)
        pre = add_noise(pre, std, prng.normal(k1, pre.shape))
    if output == "diff":
        return pre
    return soft_sa_output(pre, beta=sa_beta)


# ------------------------------------------------------------------ layer module

@dataclasses.dataclass(frozen=True)
class IRCLinearConfig:
    """Static configuration of one IRCLinear layer: shape, weight scheme,
    accumulation mode, and output stage."""
    fan_in: int
    fan_out: int
    scheme: str = "ternary"             # "ternary" (proposed) | "binary"
    bias_rows: int = 0                  # extra common-mode bias rows (<= 32)
    accumulation: str = "single_shot"   # "single_shot" | "partial_sum"
    partial_rows: int = 256
    use_bn: bool = False                # baseline in-memory BN (Fig. 13a)
    output: str = "binary"              # "binary" | "diff"


class IRCLinear:
    """A linear layer run through the QAT surrogate or the full crossbar
    simulation; a fan-in wider than one macro is tiled over several macros
    whose sensed differences combine digitally (each tile keeps its own
    nonideal effects).  Params are a flat dict {"w": [fan_in, fan_out]},
    with "bn": {"gamma", "beta", "mean", "var"} when `use_bn` is set, as
    the reference's (`convert.params_from_jax` carries them over)."""

    def __init__(self, config: IRCLinearConfig,
                 spec: MacroSpec = DEFAULT_MACRO):
        self.config = config
        self.spec = spec

    def init(self, key: torch.Tensor) -> Dict:
        """Fan-in-scaled Gaussian weights normal(split(key)[0]) *
        float32(1 / float32(sqrt(fan_in))), rounded as the reference's
        eager `init` rounds them, plus identity BN statistics with
        `use_bn`; on the key's device."""
        c = self.config
        k_w = prng.split(key)[0]
        scale = float(np.float32(1.0) / np.sqrt(np.float32(c.fan_in)))
        params = {"w": prng.normal(k_w, (c.fan_in, c.fan_out)) * scale}
        if c.use_bn:
            ones = torch.ones(c.fan_out, dtype=torch.float32,
                              device=key.device)
            params["bn"] = {"gamma": ones, "beta": torch.zeros_like(ones),
                            "mean": torch.zeros_like(ones), "var": ones}
        return params

    def quantized_weights(self, params: Dict) -> torch.Tensor:
        """Deployed weights under the configured scheme: ternary {-1,0,+1}
        (proposed) or binary {-1,+1} (baseline), straight-through."""
        if self.config.scheme == "ternary":
            return ternary_quantize(params["w"])
        return binary_quantize(params["w"])

    def map_to_planes(self, params: Dict) -> List[MappedLayer]:
        """Per-tile `MappedLayer`s of at most `spec.rows` rows each; the
        always-on bias / BN rows lead tile 0 only."""
        from repro_torch.core import mapping as mp
        c, spec = self.config, self.spec
        w_q = self.quantized_weights(params).detach()
        if c.scheme == "ternary":
            full = mp.ternary_planes(w_q, bias_rows=c.bias_rows)
        else:
            bn_units = None
            if c.use_bn:
                bn = params["bn"]
                bn_units = mp.fold_bn_to_bias_units(bn["gamma"], bn["beta"],
                                                    bn["mean"], bn["var"])
            full = mp.binary_planes(w_q, bn_bias_units=bn_units, spec=spec)
        lead = full.rows - full.fan_in
        tiles = []
        for lo in range(0, full.rows, spec.rows):
            hi = min(lo + spec.rows, full.rows)
            tile_lead = max(0, lead - lo)
            tiles.append(MappedLayer(
                g_pos=full.g_pos[lo:hi], g_neg=full.g_neg[lo:hi],
                bias_rows=tile_lead, scheme=full.scheme,
                fan_in=(hi - lo) - tile_lead))
        return tiles

    def apply(self, params: Dict, x: torch.Tensor, *, key: torch.Tensor,
              mode: str = "train",
              cfg: ni.NonidealConfig = ni.NonidealConfig.none(),
              sa_extra_units: float = 0.0) -> torch.Tensor:
        """Run the layer on x [..., fan_in]: `mode="train"` the
        differentiable QAT surrogate (`irc_linear_train`); `mode="eval"`
        the structural simulation of tile t under `fold_in(key, t)`.  A
        single tile gives its SA decisions (or its difference with
        output="diff"); several tiles sum their sensed differences (their
        ideal differences with output="diff") in tile order and threshold
        the sum at zero."""
        c, spec = self.config, self.spec
        if mode == "train":
            return irc_linear_train(key, x, params["w"], cfg=cfg, spec=spec,
                                    scheme=c.scheme, output=c.output)
        if mode != "eval":
            raise ValueError(f"mode must be 'train' or 'eval', got {mode!r}")
        x_bits = (x > 0).float()
        tiles = self.map_to_planes(params)
        multi = len(tiles) > 1
        tile_out = ("diff" if c.output == "diff"
                    else ("sensed_diff" if multi else "binary"))
        diffs, offset = [], 0
        for t, tile in enumerate(tiles):
            x_t = x_bits[..., offset:offset + tile.fan_in]
            offset += tile.fan_in
            diffs.append(crossbar_forward(
                prng.fold_in(key, t), x_t, tile, cfg=cfg, spec=spec,
                accumulation=c.accumulation, partial_rows=c.partial_rows,
                sa_extra_units=sa_extra_units, output=tile_out))
        if not multi:
            return diffs[0]
        total = sum(diffs)
        return total if c.output == "diff" else (total > 0).float()
