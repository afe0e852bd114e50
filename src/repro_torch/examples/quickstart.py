"""Quickstart: the paper's IRC macro in 60 lines, on the port.

Maps a ternary layer onto the 1024x1024 crossbar, runs the full structural
simulation under each nonideal effect (Table II columns), shows the
single-shot vs partial-sum difference (Fig. 8), calibrates the extra bias
(Table I), and holds the single-chip fused IRC MVM kernel against the
structural simulation.  The same keys as the JAX package's
`examples/quickstart.py`, so both map the same layer.

  python -m repro_torch.examples.quickstart              # on the card
  python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import prng
from repro_torch.core import (DEFAULT_MACRO, NonidealConfig, ternary_quantize,
                              ternary_planes, crossbar_forward,
                              ideal_ternary_matmul, calibrate_bias,
                              layer_current_stats, ternary_fractions)
from repro_torch.kernels.ops import irc_mvm_from_mapped
from repro_torch.runtime import resolve_device


def _agree(out: torch.Tensor, ref_sign: torch.Tensor) -> float:
    return float(torch.mean(((out > 0.5) == ref_sign).float()))


def main(argv=None) -> dict:
    """Print the quickstart's lines; return its numbers (`fractions`,
    `effects` and `accumulation` agreements, the calibrated `bias` and its
    `report`, and `kernel_agreement`, the fused kernel's output equal to
    the structural simulation's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    dev = resolve_device(ap.parse_args(argv).device)
    key = prng.PRNGKey(0, device=dev)
    fan_in, n_out, batch = 540, 64, 64      # one YOLO group: 3*3*60 inputs

    # --- ternary weights with the paper's 20/60/20 regulation -------------
    w = ternary_quantize(prng.normal(key, (fan_in, n_out)))
    fractions = [float(f) for f in ternary_fractions(w)]
    print("weight fractions (-1/0/+1):", [f"{f:.2f}" for f in fractions])
    mapped = ternary_planes(w, bias_rows=32)
    x = (prng.uniform(prng.PRNGKey(1, device=dev),
                      (batch, fan_in)) > 0.5).to(torch.float32)
    # the STE's forward value can sit an ulp off +-1; the kernel's int8
    # weights take the exact value
    ref_sign = ideal_ternary_matmul(x, torch.round(w)) > 0

    # --- each nonideal effect, one at a time (Table II structure) ---------
    effects = {
        "ideal": NonidealConfig.none(),
        "device variation": NonidealConfig(device_variation=True),
        "+ nonlinearity": NonidealConfig(device_variation=True,
                                         nonlinearity=True),
        "+ SA variation / range": NonidealConfig(device_variation=True,
                                                 nonlinearity=True,
                                                 sa_variation=True,
                                                 sensing_range=True),
        "+ IR drop (all)": NonidealConfig.all(),
    }
    agreement = {}
    print("\nbit agreement vs ideal sign (proposed design, single-shot):")
    for name, cfg in effects.items():
        out = crossbar_forward(prng.PRNGKey(2, device=dev), x, mapped,
                               cfg=cfg)
        agreement[name] = _agree(out, ref_sign)
        print(f"  {name:26s} {agreement[name]:6.1%}")

    # --- single-shot vs partial-sum (Fig. 8) ------------------------------
    cfg_nl = NonidealConfig(nonlinearity=True)
    accumulation = {}
    for acc in ("single_shot", "partial_sum"):
        out = crossbar_forward(prng.PRNGKey(2, device=dev), x, mapped,
                               cfg=cfg_nl, accumulation=acc)
        accumulation[acc] = _agree(out, ref_sign)
        print(f"nonlinearity with {acc:12s}: {accumulation[acc]:6.1%}")

    # --- extra-bias calibration (Table I) ----------------------------------
    # sparse activations (the paper's Table I regime: line currents sit near
    # the 35 uA sensing floor, e.g. Layer3_0's 29.28% failures)
    x_sparse = (prng.uniform(prng.PRNGKey(5, device=dev),
                             (batch, fan_in)) > 0.75).to(torch.float32)
    ip, ineg, p = layer_current_stats(prng.PRNGKey(3, device=dev), x_sparse,
                                      ternary_planes(w, 0))
    best, report = calibrate_bias(ip, ineg, p)
    print(f"\nbias calibration (sparse layer): best extra bias = {best} units")
    for b in sorted({0, best}):
        r = report[b]
        print(f"  bias {b:2d}: below-lower-bound {r['below_lower_bound']:.2%}"
              f"  sensing-variation {r['sensing_variation']:.2%}")

    # --- the fused kernel path matches the structural sim -----------------
    out_core = crossbar_forward(prng.PRNGKey(4, device=dev), x, mapped,
                                cfg=NonidealConfig.all())
    out_kernel = irc_mvm_from_mapped(prng.PRNGKey(4, device=dev), x, mapped,
                                     NonidealConfig.all(), DEFAULT_MACRO)
    kernel_agreement = float(torch.mean((out_core == out_kernel).float()))
    print(f"\nkernel vs structural sim agreement: {kernel_agreement:.1%}")
    return {"fractions": fractions, "effects": agreement,
            "accumulation": accumulation, "bias": best, "report": report,
            "kernel_agreement": kernel_agreement}


if __name__ == "__main__":
    main()
