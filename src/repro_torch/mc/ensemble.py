"""ChipEnsemble — pre-sampled per-chip nonideal state with a leading chips axis.

The paper's robustness claims are statistics over a population of dies.
Chip `c` of `sample_ensemble(key, ...)` carries exactly the state that
`crossbar_forward(fold_in(key, c), ...)` samples, stacked on a leading
chips axis so one batched computation (or one kernel launch) serves the
whole population.  `calibrate_ensemble_bias` is the paper's per-die
deployment flow (Sec. IV-B.4): each chip's own variation draw gives it its
own best extra-bias row count.  `deviation_planes` turns an uncalibrated
ensemble into the (effective - nominal) conductance deltas that
ensemble-aware QAT adds to its pre-activations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.calibration import calibrate_bias
from repro_torch.core.crossbar import (_accumulate, _block_reduce,
                                       sample_chip_planes)
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import MappedLayer


@dataclasses.dataclass(frozen=True)
class ChipEnsemble:
    """A population of sampled chip instances of one mapped layer.

    ep/en:      [chips, rows, n_out] effective conductances (chip identity);
    gp/gn:      placement planes, [rows, n_out] shared by every chip, or
                [chips, rows, n_out] after per-die bias calibration;
    sa_keys:    [chips, 2] int64 key words seeding each chip's per-read noise;
    chip_ids:   [chips] global chip indices (fold_in stream positions);
    bias_units: [chips] calibrated active bias rows per chip, or None.
    """
    ep: torch.Tensor
    en: torch.Tensor
    gp: torch.Tensor
    gn: torch.Tensor
    sa_keys: torch.Tensor
    chip_ids: torch.Tensor
    scheme: str
    fan_in: int
    bias_units: Optional[torch.Tensor] = None

    @property
    def n_chips(self) -> int:
        """Sampled chip instances (leading axis of ep/en)."""
        return self.ep.shape[0]

    @property
    def rows(self) -> int:
        """Crossbar rows per chip (bias rows + fan-in rows)."""
        return self.ep.shape[1]

    @property
    def n_out(self) -> int:
        """Output columns per chip."""
        return self.ep.shape[2]

    @property
    def lead_rows(self) -> int:
        """Always-on bias rows prefixed ahead of the fan-in rows."""
        return self.rows - self.fan_in

    def planes_per_chip(self) -> bool:
        """True when the placement planes vary per chip ([chips, rows,
        n_out]) rather than being one shared [rows, n_out] copy."""
        return self.gp.ndim == 3


def chip_keys(key: torch.Tensor, chip_ids: torch.Tensor) -> torch.Tensor:
    """Per-chip keys [chips, 2]: chip c <- fold_in(key, c)."""
    return prng.fold_in(key, chip_ids)


def sample_ensemble(key: torch.Tensor, mapped: MappedLayer, n_chips: int = 0,
                    *, chip_ids: Optional[torch.Tensor] = None,
                    cfg: ni.NonidealConfig = ni.NonidealConfig.all(),
                    spec: MacroSpec = DEFAULT_MACRO,
                    device=None) -> ChipEnsemble:
    """Sample `n_chips` chips (or the chips `chip_ids`) of one mapped layer;
    chip c is keyed fold_in(key, c) whatever slice is sampled."""
    if chip_ids is None:
        chip_ids = torch.arange(n_chips, dtype=torch.int64, device=key.device)
    return sample_ensemble_with_keys(chip_keys(key, chip_ids), mapped,
                                     chip_ids=chip_ids, cfg=cfg, spec=spec,
                                     device=device)


def sample_ensemble_with_keys(keys: torch.Tensor, mapped: MappedLayer, *,
                              chip_ids: Optional[torch.Tensor] = None,
                              cfg: ni.NonidealConfig = ni.NonidealConfig.all(),
                              spec: MacroSpec = DEFAULT_MACRO,
                              device=None) -> ChipEnsemble:
    """Sample chips from explicit per-chip keys [chips, 2] (how the
    detector keeps its (chip, layer, group) key lattice)."""
    assert mapped.rows <= spec.rows, (
        f"planes ({mapped.rows} rows) exceed the macro ({spec.rows}); tile first")
    if chip_ids is None:
        chip_ids = torch.arange(keys.shape[0], dtype=torch.int64,
                                device=keys.device)
    ep, en, sa_keys = sample_chip_planes(keys, mapped.g_pos, mapped.g_neg,
                                         mapped.scheme, cfg, spec, device)
    return ChipEnsemble(ep=ep, en=en, gp=mapped.g_pos, gn=mapped.g_neg,
                        sa_keys=sa_keys, chip_ids=chip_ids,
                        scheme=mapped.scheme, fan_in=mapped.fan_in)


def deviation_planes(ens: ChipEnsemble, spec: MacroSpec = DEFAULT_MACRO,
                     device=None) -> ChipEnsemble:
    """The ensemble with ep/en replaced by (effective - nominal) conductance
    deltas, the train-time surrogate's planes.

    The nominal planes are a variation-free chip's (LRS cells at unit
    conductance, the HRS leak floor elsewhere, the same floor the chips were
    sampled with), so the fused IRC MVM on them with every effect off and
    output="diff" is each chip's frozen linear variation error; the deltas
    are exactly zero when the chips were sampled without device variation.
    Uncalibrated ensembles only (calibration floors conductances)."""
    if ens.bias_units is not None:
        raise ValueError("deviation_planes needs an uncalibrated ensemble")
    leak = ni._device_or_analytic(device).hrs_leak_units(spec)
    gp = ens.gp if ens.planes_per_chip() else ens.gp[None]
    gn = ens.gn if ens.planes_per_chip() else ens.gn[None]
    ep0 = gp + (1.0 - gp) * leak
    en0 = gn + (1.0 - gn) * leak
    return dataclasses.replace(ens, ep=ens.ep - ep0, en=ens.en - en0)


def _chip_current_stats(x_ext: torch.Tensor, ep: torch.Tensor,
                        ep_neg: torch.Tensor, gp: torch.Tensor,
                        gn: torch.Tensor, spec: MacroSpec, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i_pos, i_neg, p_pair), each [chips, B * n_out], of every chip on a
    calibration batch x_ext [B, rows], with the physical effects the SA
    sees (variation already in the planes, IR drop here) and no periphery
    model."""
    cfg = ni.NonidealConfig(device_variation=True, ir_drop=True)
    blk = spec.ir_block
    i_pos, p_pos = _accumulate(_block_reduce(x_ext, ep, blk),
                               _block_reduce(x_ext, gp, blk),
                               cfg, spec, "single_shot", 256, device)
    i_neg, p_neg = _accumulate(_block_reduce(x_ext, ep_neg, blk),
                               _block_reduce(x_ext, gn, blk),
                               cfg, spec, "single_shot", 256, device)
    chips = ep.shape[0]
    p_pair = (p_pos + p_neg).expand(i_pos.shape)
    return (i_pos.reshape(chips, -1), i_neg.reshape(chips, -1),
            p_pair.reshape(chips, -1))


def calibrate_ensemble_bias(ens: ChipEnsemble, x_calib_bits: torch.Tensor,
                            spec: MacroSpec = DEFAULT_MACRO,
                            candidates: Sequence[int] = (0, 4, 8, 12, 16,
                                                         20, 24, 28, 32),
                            device=None) -> ChipEnsemble:
    """Per-die extra-bias calibration (Sec. IV-B.4 deployment flow).

    The ensemble's `lead_rows` are the physical bias-row budget; each chip
    keeps only its calibrated count b_c <= lead_rows of them active.
    Deactivated rows revert to HRS cells on both planes (conductance ->
    HRS leak, LRS count -> 0), so the placement planes become per chip.
    The calibration currents are measured with the bias rows off (the
    candidates are added analytically), then scored on the host, one chip
    at a time, as the reference does."""
    lead = ens.lead_rows
    if lead <= 0:
        raise ValueError("calibration needs bias rows in the mapping "
                         "(lead_rows > 0)")
    cand = tuple(c for c in candidates if c <= lead)
    x = x_calib_bits.float()
    x_ext = torch.cat([torch.zeros(x.shape[:-1] + (lead,), device=x.device),
                       x], dim=-1)
    stats = _chip_current_stats(x_ext, ens.ep, ens.en, ens.gp, ens.gn, spec,
                                device)
    i_pos, i_neg, p_pair = (t.cpu() for t in stats)
    bias = torch.tensor([calibrate_bias(ip, ineg, pp, spec, cand)[0]
                         for ip, ineg, pp in zip(i_pos, i_neg, p_pair)],
                        dtype=torch.float32, device=ens.ep.device)
    row = torch.arange(ens.rows, dtype=torch.float32, device=bias.device)
    on = (row[None, :] < bias[:, None]) | (row[None, :] >= lead)
    m = on[:, :, None]
    leak = ni._device_or_analytic(device).hrs_leak_units(spec)
    gp = ens.gp if ens.planes_per_chip() else ens.gp[None]
    gn = ens.gn if ens.planes_per_chip() else ens.gn[None]
    return dataclasses.replace(
        ens, ep=torch.where(m, ens.ep, leak), en=torch.where(m, ens.en, leak),
        gp=(gp * m).contiguous(), gn=(gn * m).contiguous(), bias_units=bias)
