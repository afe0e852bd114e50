"""Plain reference of one proposed-design IRC macro layer (the layer-level
Table II): latent weights [fan_in, n_out] mapped ternary at the
configuration's fractions (20/60/20) over the whole layer onto differential planes behind the bias rows, a batch of
{0,1} input vectors, and the population of dies keyed fold_in(key, c).

`bits` gives dies' SA decisions [dies, batch, n_out]; `ideal` the ideal
digital decisions (x . w > 0) that bit agreement is measured against;
`agreement` a die's share of decisions equal to them.  Matrix products go
through `irc.mm`, so precision="tf32" runs the same reference at TF32's
precision (the control).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from reference import irc
from reference import threefry as tf

#: dies sampled and evaluated at once
DIE_BLOCK = 64


def ideal(cfg: Dict, w_latent: torch.Tensor, x_bits: torch.Tensor
          ) -> torch.Tensor:
    """Ideal decisions [batch, n_out]: x . ternary(w) > 0, exact in
    float64."""
    w_t = irc.ternary_map(w_latent, *irc.scheme(cfg))
    return ((x_bits.double() @ w_t.double()) > 0).float()


def bits(cfg: Dict, w_latent: torch.Tensor, x_bits: torch.Tensor,
         key: torch.Tensor, chips: Sequence[int], *, effects: irc.Effects,
         device: irc.Device, precision: str = "float32") -> torch.Tensor:
    """SA decisions [len(chips), batch, n_out] of dies `chips` under key
    `key` ([2] int64)."""
    macro = irc.Macro.from_config(cfg["macro"])
    gp, gn = irc.planes(irc.ternary_map(w_latent, *irc.scheme(cfg)),
                        cfg["bias_rows"])
    ones = torch.ones(x_bits.shape[0], cfg["bias_rows"], device=x_bits.device)
    x = torch.cat([ones, x_bits.float()], -1)
    out = []
    with torch.no_grad():
        for lo in range(0, len(chips), DIE_BLOCK):
            ids = torch.as_tensor(list(chips[lo:lo + DIE_BLOCK]),
                                  dtype=torch.int64, device=x.device)
            ep, en, k_sa = irc.sample_dies(tf.fold_in(key, ids), gp, gn,
                                           macro, effects, device)
            out += [irc.evaluate(x, ep[i], en[i], gp, gn, k_sa[i], 0, macro,
                                 effects, precision)
                    for i in range(ids.numel())]
    return torch.stack(out)


def agreement(die_bits: torch.Tensor, ideal_bits: torch.Tensor
              ) -> torch.Tensor:
    """Each die's share of decisions equal to the ideal ones: [dies]."""
    return ((die_bits > 0.5) == (ideal_bits > 0.5)).float().mean(dim=(-2, -1))
