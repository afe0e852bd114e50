"""One benchmark per paper table/figure (JETCAS 2022), on the port.

The twins of the nine functions of the JAX package's
`benchmarks/paper_tables.py`, at the same keys and shapes, each returning
rows (name, us_per_call, derived) with the reference's names and derived
fields.  The paper-scale Table II (trained-detector mAP ablation) lives in
`repro_torch.examples.train_detector`; here a bit-error proxy on
representative group-conv layers keeps the paper's orderings, and
`table2_detector_map` reports the population mean±std mAP@0.5 of a briefly
QAT'd smoke detector through the whole-network MC engine.  Unlike the
reference's `table2_ensemble_qat`, nothing is written to a file: its
numbers are in its rows.

On the card the ideal digital outputs run the ternary matmul kernel, the
proposed detector's sweeps the fused IRC MVM kernel and every die draw the
threefry kernel; `_timeit` synchronizes the card around its laps.

  python -m repro_torch.examples.paper_tables [--only substr] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Tuple

import torch

from repro_torch import prng
from repro_torch.core import (MacroSpec, NonidealConfig, nonlinearity_ratio,
                              sa_required_diff, ternary_quantize,
                              binary_quantize, ternary_planes, binary_planes,
                              crossbar_forward, ideal_ternary_matmul,
                              calibrate_bias, layer_current_stats, wl_point)
from repro_torch.mc.engine import TABLE2_ABLATION as _ABLATION
from repro_torch.runtime import DeviceLike, resolve_device

Row = Tuple[str, float, str]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, dev: torch.device, n=3) -> float:
    """Microseconds a call of `fn`, the mean of `n` laps after a warm-up
    call, each lap ending when the card has finished."""
    fn()  # warmup / first launches
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        _sync(dev)
    return (time.perf_counter() - t0) / n * 1e6


def _agree(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.mean(((out > 0.5) == ref).float()))


def _ideal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # the STE's forward value can sit an ulp off +-1; the kernel's int8
    # weights take the exact value
    return ideal_ternary_matmul(x, torch.round(w))


def _layer(dev, seed=0, fan_in=540, n_out=60, batch=256, density=0.5,
           scheme="ternary", bias_rows=32):
    w_lat = prng.normal(prng.PRNGKey(seed, device=dev), (fan_in, n_out))
    if scheme == "ternary":
        w = ternary_quantize(w_lat)
        mapped = ternary_planes(w, bias_rows=bias_rows)
    else:
        w = binary_quantize(w_lat)
        mapped = binary_planes(w)
    x = (prng.uniform(prng.PRNGKey(seed + 1, device=dev),
                      (batch, fan_in)) > 1 - density).to(torch.float32)
    return w, mapped, x


def fig7_nonlinearity(device: DeviceLike = "cuda") -> List[Row]:
    dev = resolve_device(device)
    p = torch.arange(0, 321, dtype=torch.float32, device=dev)
    us = _timeit(lambda: nonlinearity_ratio(p), dev)
    r = nonlinearity_ratio(p)
    return [("fig7_nonlinearity_ratio", us,
             f"ratio(p=3)={float(r[3]):.2f};ratio(p=205)={float(r[205]):.3f}")]


def fig9_sa_variation(device: DeviceLike = "cuda") -> List[Row]:
    dev = resolve_device(device)
    p = torch.arange(0, 321, dtype=torch.float32, device=dev)
    us = _timeit(lambda: sa_required_diff(p), dev)
    g = sa_required_diff(p)
    return [("fig9_sa_required_diff", us,
             f"g(0)={float(g[0]):.1f};g(300)={float(g[300]):.1f}units")]


def fig14_wl_voltage(device: DeviceLike = "cuda") -> List[Row]:
    """WL voltage <-> power <-> accuracy trade-off (power model + bit
    agreement analog of the paper's mAP curve)."""
    dev = resolve_device(device)
    rows: List[Row] = []
    w, _, x = _layer(dev)
    ref = _ideal(x, w) > 0
    for v in (0.40, 0.42, 0.44, 0.46, 0.48):
        spec = MacroSpec(wl_voltage=v)
        mapped = ternary_planes(w, bias_rows=32)

        def run(spec=spec, mapped=mapped):
            return crossbar_forward(prng.PRNGKey(2, device=dev), x, mapped,
                                    cfg=NonidealConfig(device_variation=True),
                                    spec=spec)
        us = _timeit(run, dev, n=1)
        agree = _agree(run(), ref)
        i_ua, sigma = wl_point(v)
        energy = spec.read_energy_pj(activated_lrs=0.2 * 1024 * 0.5)
        rows.append((f"fig14_wl_{v:.2f}V", us,
                     f"sigma={sigma:.3f};E={energy:.2f}pJ;agree={agree:.3f}"))
    return rows


def table1_sensing(device: DeviceLike = "cuda") -> List[Row]:
    """Sensing failures w/o vs w/ calibrated extra bias, for a dense and a
    sparse layer (the paper's per-layer Table I structure)."""
    dev = resolve_device(device)
    rows: List[Row] = []
    for name, density in (("dense_layer", 0.5), ("sparse_layer", 0.25)):
        w, mapped0, x = _layer(dev, density=density, bias_rows=0)
        _sync(dev)
        t0 = time.perf_counter()
        ip, ineg, p = layer_current_stats(prng.PRNGKey(3, device=dev), x,
                                          mapped0)
        best, report = calibrate_bias(ip, ineg, p)
        us = (time.perf_counter() - t0) * 1e6
        r0, rb = report[0], report[best]
        rows.append((f"table1_{name}", us,
                     f"bias={best};below_lb:{r0['below_lower_bound']:.3f}"
                     f"->{rb['below_lower_bound']:.3f};"
                     f"sa_var:{r0['sensing_variation']:.3f}"
                     f"->{rb['sensing_variation']:.3f}"))
    return rows


DESIGNS = (("proposed", "ternary", "single_shot", 32),
           ("baseline", "binary", "partial_sum", 0))


def table2_ablation_proxy(device: DeviceLike = "cuda") -> List[Row]:
    """Bit-agreement ablation, proposed vs baseline design (Table II
    ordering; full mAP version: `train_detector`)."""
    dev = resolve_device(device)
    rows: List[Row] = []
    for design, scheme, acc, bias in DESIGNS:
        w, mapped, x = _layer(dev, scheme=scheme, bias_rows=bias)
        ref = _ideal(x, w) > 0
        vals = []
        for name, cfg in _ABLATION:
            out = crossbar_forward(prng.PRNGKey(4, device=dev), x, mapped,
                                   cfg=cfg, accumulation=acc,
                                   partial_rows=212)
            vals.append(f"{name}={_agree(out, ref):.3f}")
        us = _timeit(lambda: crossbar_forward(
            prng.PRNGKey(4, device=dev), x, mapped, cfg=NonidealConfig.all(),
            accumulation=acc, partial_rows=212), dev, n=1)
        rows.append((f"table2_{design}", us, ";".join(vals)))
    return rows


def table2_mc_ensemble(device: DeviceLike = "cuda") -> List[Row]:
    """Table II as the paper states it: mean±std accuracy drop over a
    POPULATION of sampled chips (`mc.engine.run_ablation`), proposed vs
    baseline design."""
    from repro_torch.mc.engine import McConfig, run_ablation

    dev = resolve_device(device)
    rows: List[Row] = []
    for design, scheme, acc, bias in DESIGNS:
        w, mapped, x = _layer(dev, scheme=scheme, bias_rows=bias)
        ref = (_ideal(x, w) > 0).to(torch.float32)
        mc = McConfig(n_chips=16, chunk_size=16, accumulation=acc,
                      partial_rows=212)
        _sync(dev)
        t0 = time.perf_counter()
        results = run_ablation(prng.PRNGKey(4, device=dev), mapped, x,
                               ref_bits=ref, mc=mc)
        us = (time.perf_counter() - t0) * 1e6
        ideal = results["ideal"].metrics["bit_agreement"]["mean"]
        vals = []
        for name, res in results.items():
            m = res.metrics["bit_agreement"]
            vals.append(f"{name}={m['mean']:.3f}±{m['std']:.3f}"
                        f"(drop{ideal - m['mean']:.3f})")
        rows.append((f"table2_mc_{design}", us, ";".join(vals)))
    return rows


def _smoke_detector(scheme: str):
    from repro_torch.configs import yolo_irc
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.models.detector import IRCDetector
    det = IRCDetector(yolo_irc.smoke(scheme))
    data = SyntheticDetectionData(img_hw=det.cfg.img_hw,
                                  stride=det.cfg.strides,
                                  n_classes=det.cfg.n_classes,
                                  n_anchors=det.cfg.n_anchors)
    return det, data


def table2_detector_map(device: DeviceLike = "cuda") -> List[Row]:
    """Table II in the paper's own units: mean±std mAP@0.5 over a chip
    POPULATION of the WHOLE detector (`run_ablation_detector`), after a
    short QAT on the smoke geometry."""
    from repro_torch.mc.detector_mc import run_ablation_detector
    from repro_torch.mc.engine import McConfig
    from repro_torch.train.det_qat import quick_qat

    dev = resolve_device(device)
    rows: List[Row] = []
    for design, scheme in (("proposed", "ternary"), ("baseline", "binary")):
        det, data = _smoke_detector(scheme)
        params = quick_qat(det, data, 40, 4, device=dev)
        params = det.calibrate_bn(params, torch.from_numpy(
            data.batch_for_step(999, 16).images).to(dev))
        ev = data.batch_for_step(1000, 4)
        images = torch.from_numpy(ev.images).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        results = run_ablation_detector(
            prng.PRNGKey(4, device=dev), det, params, images, ev.boxes,
            ev.classes, mc=McConfig(n_chips=8, chunk_size=8))
        us = (time.perf_counter() - t0) * 1e6
        ideal = results["ideal"].metrics["map50"]["mean"]
        vals = [f"{name}={res.metrics['map50']['mean']:.3f}"
                f"±{res.metrics['map50']['std']:.3f}"
                f"(drop{ideal - res.metrics['map50']['mean']:.3f})"
                for name, res in results.items()]
        rows.append((f"table2_detector_map_{design}", us, ";".join(vals)))
    return rows


def table2_ensemble_qat(device: DeviceLike = "cuda") -> List[Row]:
    """Table-II-style population comparison of the QAT surrogates: mean±std
    mAP@0.5 over a chip population for a SINGLE-DRAW-trained vs an
    ENSEMBLE-trained checkpoint (same root key, same surrogate-noise
    config, same step count: the chips axis is the only difference)."""
    from repro_torch.mc.detector_mc import run_mc_detector
    from repro_torch.mc.engine import McConfig
    from repro_torch.train.det_qat import quick_qat

    dev = resolve_device(device)
    det, data = _smoke_detector("ternary")
    noise = NonidealConfig.all()
    root = prng.PRNGKey(1, device=dev)
    checkpoints = {
        "single": quick_qat(det, data, 40, 4, cfg_ni=noise, key=root,
                            device=dev),
        "ens4": quick_qat(det, data, 40, 4, cfg_ni=noise, key=root,
                          train_chips=4, device=dev),
    }
    calib = torch.from_numpy(data.batch_for_step(999, 16).images).to(dev)
    ev = data.batch_for_step(1000, 4)
    images = torch.from_numpy(ev.images).to(dev)
    mc = McConfig(n_chips=8, chunk_size=8)
    rows: List[Row] = []
    for name, params in checkpoints.items():
        params = det.calibrate_bn(params, calib)
        _sync(dev)
        t0 = time.perf_counter()
        res = run_mc_detector(prng.PRNGKey(4, device=dev), det, params,
                              images, ev.boxes, ev.classes, mc=mc)
        us = (time.perf_counter() - t0) * 1e6
        m = res.metrics["map50"]
        rows.append((f"table2_qat_{name}", us,
                     f"map50={m['mean']:.3f}±{m['std']:.3f};"
                     f"chips={mc.n_chips};qat_steps=40"))
    return rows


def table4_tolerance(device: DeviceLike = "cuda") -> List[Row]:
    """Tolerance limits: device sigma sweep + SA variation margin sweep."""
    dev = resolve_device(device)
    rows: List[Row] = []
    w, _, x = _layer(dev)
    ref = _ideal(x, w) > 0
    mapped = ternary_planes(w, bias_rows=32)
    for sigma in (0.42, 0.43, 0.44, 0.47, 0.52):
        spec = dataclasses.replace(MacroSpec(), sigma_override=sigma)
        out = crossbar_forward(prng.PRNGKey(5, device=dev), x, mapped,
                               cfg=NonidealConfig(device_variation=True),
                               spec=spec)
        rows.append((f"table4_devstd_{sigma:.2f}", 0.0,
                     f"agree={_agree(out, ref):.3f}"))
    for extra in (0.0, 1.0, 2.0, 3.0):
        out = crossbar_forward(prng.PRNGKey(7, device=dev), x, mapped,
                               cfg=NonidealConfig(sa_variation=True),
                               sa_extra_units=extra)
        rows.append((f"table4_sa_plus{int(extra)}", 0.0,
                     f"agree={_agree(out, ref):.3f}"))
    return rows


ALL = [fig7_nonlinearity, fig9_sa_variation, fig14_wl_voltage,
       table1_sensing, table2_ablation_proxy, table2_mc_ensemble,
       table2_detector_map, table2_ensemble_qat, table4_tolerance]


def main(argv=None) -> List[Row]:
    """Print the `name,us_per_call,derived` CSV of the functions whose name
    holds `--only` (all by default) and return their rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="run only the functions whose name holds this")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows: List[Row] = []
    print("name,us_per_call,derived")
    for fn in ALL:
        if args.only and args.only not in fn.__name__:
            continue
        for name, us, derived in fn(device=dev):
            print(f"{name},{us:.1f},{derived}", flush=True)
            rows.append((name, us, derived))
    return rows


if __name__ == "__main__":
    main()
