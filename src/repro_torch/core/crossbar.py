"""Structural crossbar simulation of one IRC macro (the paper's core).

`crossbar_forward` samples one chip (`sample_chip_planes`: per-cell device
variation and HRS leak, drawn once per die) and runs it (`crossbar_apply`:
32-cell IR-drop blocks, single-shot accumulation nonlinearity, SA offset and
limited sensing range).  It is the single-chip plain path that the chip
ensembles and the fused kernel are held against.  The baseline's
partial-sum accumulation and the multi-macro `sensed_diff` readout come with
the baseline design in a later slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import MappedLayer, extend_inputs


def _block_reduce(x_ext: torch.Tensor, plane: torch.Tensor, block: int
                  ) -> torch.Tensor:
    """Per-IR-block partial currents: x_ext [..., R], plane [R, N]
    -> [..., nb, N] with nb = ceil(R / block) (zero rows at the far end)."""
    rows, n_out = plane.shape
    nb = -(-rows // block)
    pad = nb * block - rows
    if pad:
        x_ext = F.pad(x_ext, (0, pad))
        plane = F.pad(plane, (0, 0, 0, pad))
    xb = x_ext.reshape(x_ext.shape[:-1] + (nb, block))
    pb = plane.reshape(nb, block, n_out)
    return torch.einsum("...bk,bkn->...bn", xb, pb)


def _accumulate(blocks: torch.Tensor, counts: torch.Tensor,
                cfg: ni.NonidealConfig, spec: MacroSpec, accumulation: str,
                partial_rows: int, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IR drop + single-shot nonlinearity on per-block currents [..., nb, N];
    returns (bit-line current [..., N], activated LRS count [..., N])."""
    if accumulation != "single_shot":
        raise NotImplementedError(
            f"accumulation={accumulation!r} comes with the baseline-design "
            "slice (binary weights, partial sums, in-memory BN)")
    if cfg.ir_drop:
        blocks = blocks * ni._device_or_analytic(device).ir_drop_factors(
            blocks, spec, axis=-2)
    p_total = torch.sum(counts, dim=-2)
    i_line = torch.sum(blocks, dim=-2)
    if cfg.nonlinearity:
        i_line = ni.apply_nonlinearity(i_line, p_total)
    return i_line, p_total


def sample_chip_planes(key: torch.Tensor, g_pos: torch.Tensor,
                       g_neg: torch.Tensor, scheme: str,
                       cfg: ni.NonidealConfig,
                       spec: MacroSpec = DEFAULT_MACRO, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample chip instances: (ep, en, k_sa) from key(s) [..., 2].

    The key splits into 3 (positive-plane mask, negative-plane mask, SA key)
    as in the reference, so chip identity matches it bit for bit.  Key batch
    axes lead ep/en ([chips, R, N] from [chips, 2] keys) and k_sa."""
    if scheme != "ternary":
        raise NotImplementedError(
            f"scheme={scheme!r} comes with the baseline-design slice")
    dev = ni._device_or_analytic(device)
    ks = prng.split(key, 3)
    k_var_p, k_var_n, k_sa = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
    lead = key.shape[:-1]
    ep = g_pos.expand(lead + g_pos.shape)
    en = g_neg.expand(lead + g_neg.shape)
    if cfg.device_variation:
        ep = g_pos * dev.variation_mask(k_var_p, g_pos.shape, spec)
        en = g_neg * dev.variation_mask(k_var_n, g_neg.shape, spec)
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
    output="binary" gives SA decisions, "diff" the analog difference."""
    blk = spec.ir_block
    i_pos, p_pos = _accumulate(_block_reduce(x_ext, ep, blk),
                               _block_reduce(x_ext, gp, blk),
                               cfg, spec, accumulation, partial_rows, device)
    i_neg, p_neg = _accumulate(_block_reduce(x_ext, en, blk),
                               _block_reduce(x_ext, gn, blk),
                               cfg, spec, accumulation, partial_rows, device)
    if output == "diff":
        return i_pos - i_neg
    if output != "binary":
        raise NotImplementedError(
            f"output={output!r} comes with the multi-macro IRCLinear slice")
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
