"""ChipEnsemble — pre-sampled per-chip nonideal state with a leading chips axis.

The paper's robustness claims are statistics over a population of dies.
Chip `c` of `sample_ensemble(key, ...)` carries exactly the state that
`crossbar_forward(fold_in(key, c), ...)` samples, stacked on a leading
chips axis so one batched computation (or one kernel launch) serves the
whole population.  Per-die bias calibration comes in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.core.crossbar import sample_chip_planes
from repro_torch.core.macro import MacroSpec, DEFAULT_MACRO
from repro_torch.core.mapping import MappedLayer


@dataclasses.dataclass(frozen=True)
class ChipEnsemble:
    """A population of sampled chip instances of one mapped layer.

    ep/en:    [chips, rows, n_out] effective conductances (chip identity);
    gp/gn:    placement planes, [rows, n_out] shared by every chip;
    sa_keys:  [chips, 2] int64 key words seeding each chip's per-read noise;
    chip_ids: [chips] global chip indices (fold_in stream positions).
    """
    ep: torch.Tensor
    en: torch.Tensor
    gp: torch.Tensor
    gn: torch.Tensor
    sa_keys: torch.Tensor
    chip_ids: torch.Tensor
    scheme: str
    fan_in: int

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
