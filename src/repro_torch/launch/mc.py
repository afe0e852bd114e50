"""CLI for the chip-population Monte Carlo (Table II).

  --network layer (default): a population of sampled chips of ONE IRC layer,
  Table II columns of mean±std bit agreement with the ideal digital output
  (the mAP-drop proxy), plus quantiles and throughput.

  python -m repro_torch.launch.mc --chips 64 --ablation table2 --backend kernel
  python -m repro_torch.launch.mc --chips 64 --scheme binary --bias-rows 0 \\
      --accumulation partial_sum --ablation table2      # baseline design

  --network detector: whole-network mAP@0.5 per chip of the detector at the
  smoke geometry `yolo_irc.smoke(--det-scheme)` (32x32 images), as in the
  JAX package's CLI.  The proposed design (`--det-scheme ternary`) runs
  every group conv through the fused IRC MVM kernel on the card; the
  baseline (`--det-scheme binary`: in-memory BN, partial sums) through the
  plain batched route, as the reference does.

  python -m repro_torch.launch.mc --network detector --chips 16 \\
      --ablation table2 [--det-scheme binary] [--det-steps 50 \\
      [--train-chips 4 --resample-every 5]]

`--det-backend` routes the detector's group convs as the JAX CLI's flag
does: `auto` (default) as `repro_torch.kernels.autotune`'s table measured
on this card says (a problem it has no entry for runs the kernel),
`kernel` forces the fused IRC MVM, `jnp` (the JAX CLI's name) or its
alias `plain` the plain batched route.

Weights from the seed, drawn through the port's threefry as the
reference's CLI draws them (the detector's by `IRCDetector.init(PRNGKey(
seed))`, the reference's `materialize`), so both CLIs sweep the same
network at the same seed.  `--device-model {analytic,measured}` picks the
device backend the dies are sampled from (`repro_torch.device`) and
`--t-days 0,30,365` repeats every column at each deployment age
(`RetentionDrift`), labels suffixed `@t<age>d` when there are several
ages, each drop measured against the same age's ideal column; BN is
calibrated once per checkpoint.

  python -m repro_torch.launch.mc --network detector --chips 16 \\
      --device-model measured --t-days 0,30,365

`--device` (cuda or cpu) is the torch device, not the device model.  The
detector sweeps one checkpoint per training setting, as the JAX CLI does:
`init` without
QAT; `qat` after `--det-steps` single-draw QAT steps (`quick_qat`); with
`--train-chips N`, `single` and `ensN`, single-draw and N-chip
ensemble-aware QAT from the same root key PRNGKey(seed + 1) with the
surrogate noise of every effect on.  The layer's ideal reference bits go
through the ternary matmul kernel on the card.  `--device cpu` runs the
plain PyTorch path on the CPU.

Every run gets a `<--run-dir>/<run_id>/` directory ('' disables it), as
the JAX CLI's: `manifest.json` (args, git SHA, torch and CUDA versions,
host, the card's name and power limit), the `metrics.jsonl` event stream
(per-chunk per-chip values and the running standard error),
`per_chip_<metric>_<label>.npy`, `report.json` and the machine-readable
`results.csv` (or wherever `--out` points), and with `--trace` a
`torch.profiler` trace.  `--stderr-target T` stops each sweep at the first
chunk boundary where the mean's standard error is at or under T.

  python -m repro_torch.launch.mc --chips 1024 --stderr-target 0.002
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

#: --det-backend -> the detector's `use_kernel`; `jnp` is the JAX CLI's
#: name of the plain batched route, `plain` its alias
DET_BACKENDS = {"auto": None, "jnp": False, "plain": False, "kernel": True}


def _ablation_columns(ablation: str, table):
    """--ablation -> named columns; the ideal column always runs."""
    if ablation == "table2":
        return list(table)
    by_name = dict(table)
    if ablation not in by_name:
        raise SystemExit(f"unknown ablation column: {ablation!r} "
                         f"(choices: table2, {', '.join(by_name)})")
    cols = [("ideal", by_name["ideal"])]
    if ablation != "ideal":
        cols.append((ablation, by_name[ablation]))
    return cols


def _parse_t_days(text):
    """--t-days "0,30,365" -> [0.0, 30.0, 365.0] (one age per sweep pass)."""
    try:
        ts = [float(t) for t in str(text).split(",") if t.strip() != ""]
    except ValueError:
        raise SystemExit(f"--t-days must be a comma list of numbers, "
                         f"got {text!r}")
    if not ts:
        raise SystemExit("--t-days needs at least one age")
    if any(t < 0 for t in ts):
        raise SystemExit("--t-days ages must be >= 0")
    return ts


def _age_label(name, t, ts):
    """Column label with the age suffixed when sweeping multiple ages."""
    return name if len(ts) == 1 else f"{name}@t{t:g}d"


def _make_runlog(args):
    """The run's RunLog under `<run-dir>/<run_id>/` (the no-op log when
    --run-dir is ''), its trace started with --trace."""
    from repro_torch.obs import maybe_runlog
    obs = maybe_runlog(bool(args.run_dir), f"mc-{args.network}",
                       args=vars(args), root=args.run_dir,
                       run_id=args.run_id or None)
    if obs.path is not None:
        print(f"# run dir: {obs.path}")
    if args.trace:
        obs.start_trace()
    return obs


def _csv_row(m: dict, drop: float, res, device_model: str, t: float) -> str:
    """The CSV columns shared by both networks, from mean to compile_s,
    then the device model and the age."""
    q = [m.get(k, float("nan")) for k in ("q05", "q50", "q95")]
    return (f"{m['mean']:.6f},{m['std']:.6f},{drop:.6f},{q[0]:.6f},"
            f"{q[1]:.6f},{q[2]:.6f},{res.n_chips},"
            f"{res.chips_per_sec:.2f},{res.compile_s:.4f},"
            f"{device_model},{t:g}")


def _write_csv(args, obs, lines) -> None:
    """The machine-readable CSV: `--out PATH`, else `<run_dir>/results.csv`."""
    text = "\n".join(lines) + "\n"
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
    else:
        out = obs.write_text("results.csv", text)
    if out is not None:
        print(f"# wrote {out}")


def _table(results, metric: str, ideal: float, device_model: str,
           t: float) -> dict:
    """Print one row per labelled column (mean±std, drop against the same
    age's ideal mean `ideal`, quantiles, throughput) and return the
    report's per-column entries."""
    rows = {}
    for name, res in results.items():
        m = res.metrics[metric]
        print(f"{name:14s} {m['mean']:14.4f}±{m['std']:6.4f} "
              f"{ideal - m['mean']:7.4f} {m.get('q05', float('nan')):7.4f} "
              f"{m.get('q50', float('nan')):7.4f} "
              f"{m.get('q95', float('nan')):7.4f} {res.n_chips:5d} "
              f"{res.chips_per_sec:9.3f} {res.compile_s:8.3f}")
        rows[name] = {
            "metrics": res.metrics, "wall_s": res.wall_s,
            "chips_per_sec": res.chips_per_sec,
            "first_chunk_s": res.compile_s, "enqueue_s": res.enqueue_s,
            "device_s": res.device_s, "host_s": res.host_s,
            "device_model": device_model, "t_days": t,
            f"per_chip_{metric}": res.per_chip[metric].tolist()}
    return rows


def _header(metric: str) -> None:
    print(f"{'config':14s} {metric + ' mean±std':>22s} {'drop':>7s} "
          f"{'q05':>7s} {'q50':>7s} {'q95':>7s} {'chips':>5s} "
          f"{'chips/s':>9s} {'first_s':>8s}")


def _finish(args, obs, report: dict) -> dict:
    """Add the kernel launch counts to the report and write it into the
    run dir and to `--json`."""
    from repro_torch.kernels import ops
    report["kernel_launches"] = dict(ops.LAUNCHES)
    print(f"# kernel launches {json.dumps(ops.LAUNCHES)}")
    obs.write_text("report.json", json.dumps(report, indent=1))
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        print(f"# wrote {out}")
    return report


def build_layer(args, device):
    """The layer under test, drawn from `args.seed` with the reference's
    keys: (mapped planes, word-line bits x [batch, fan_in], ideal reference
    bits [batch, n_out])."""
    import torch
    from repro_torch import prng
    from repro_torch.core.crossbar import ideal_ternary_matmul
    from repro_torch.core.mapping import binary_planes, ternary_planes
    from repro_torch.core.ternary import binary_quantize, ternary_quantize

    k_w, k_x = prng.split(prng.PRNGKey(args.seed, device=device))
    w_lat = prng.normal(k_w, (args.fan_in, args.n_out))
    if args.scheme == "ternary":
        w = ternary_quantize(w_lat)
        mapped = ternary_planes(w, bias_rows=args.bias_rows)
    else:
        w = binary_quantize(w_lat)
        mapped = binary_planes(w)
    x = (prng.uniform(k_x, (args.batch, args.fan_in))
         > 1.0 - args.density).to(torch.float32)
    # the STE's forward value can sit an ulp off +-1; the kernel's int8
    # weights take the exact value
    ref_bits = (ideal_ternary_matmul(x, torch.round(w)) > 0).to(
        torch.float32)
    return mapped, x, ref_bits


def run_layer(args) -> dict:
    """Population bit agreement of one layer per ablation column and age;
    prints a table, returns the report."""
    from repro_torch import prng
    from repro_torch.device import get_device_model
    from repro_torch.kernels import ops
    from repro_torch.mc.engine import McConfig, TABLE2_ABLATION, run_mc
    from repro_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    columns = _ablation_columns(args.ablation, TABLE2_ABLATION)
    ts = _parse_t_days(args.t_days)
    obs = _make_runlog(args)
    ops.reset_launches()
    mapped, x, ref_bits = build_layer(args, dev)
    mc = McConfig(n_chips=args.chips, chunk_size=args.chunk,
                  accumulation=args.accumulation, backend=args.backend,
                  calibrate=args.calibrate)
    key = prng.PRNGKey(args.seed, device=dev)

    print(f"# {args.scheme} {args.fan_in}x{args.n_out} batch={args.batch} "
          f"chips={args.chips} chunk={args.chunk} "
          f"accumulation={args.accumulation} backend={args.backend} "
          f"device={dev} device_model={args.device_model} "
          f"t_days={','.join(f'{t:g}' for t in ts)}"
          + (" calibrated" if args.calibrate else ""))
    _header("bit_agreement")
    rows = {}
    csv_lines = ["config,agree_mean,agree_std,drop_vs_ideal,q05,q50,q95,"
                 "chips,chips_per_s,compile_s,device_model,t_days"]
    for t in ts:
        device = get_device_model(args.device_model, t_days=t)
        results = {}
        for name, cfg in columns:
            obs.log_event("ablation_column", column=name,
                          device_model=args.device_model, t_days=t)
            results[_age_label(name, t, ts)] = run_mc(
                key, mapped, x, ref_bits=ref_bits,
                mc=dataclasses.replace(mc, cfg=cfg, device=device), obs=obs,
                stderr_target=args.stderr_target)
        # the drop is measured against the same age's simulated ideal
        ideal = results[_age_label("ideal", t, ts)].metrics[
            "bit_agreement"]["mean"]
        rows.update(_table(results, "bit_agreement", ideal,
                           args.device_model, t))
        for label, res in results.items():
            m = res.metrics["bit_agreement"]
            csv_lines.append(f"{label}," + _csv_row(
                m, ideal - m["mean"], res, args.device_model, t))
            for metric in ("bit_agreement", "ones_fraction"):
                obs.save_array(f"per_chip_{metric}_{label}",
                               res.per_chip[metric])
            rows[label]["bias_units"] = (res.bias_units.tolist()
                                         if res.bias_units is not None
                                         else None)
    _write_csv(args, obs, csv_lines)
    report = _finish(args, obs, {"args": vars(args),
                                 "run_id": obs.manifest.get("run_id"),
                                 "results": rows})
    obs.finalize(status="ok", network="layer",
                 device_model=args.device_model, t_days=ts)
    return report


def _train_checkpoints(args, det, data, dev) -> dict:
    """The checkpoints to sweep: {"init": the seed's weights} without QAT;
    {"qat": ...} after `--det-steps` single-draw steps; with
    `--train-chips N`, {"single", "ensN"}: single-draw and N-chip
    ensemble-aware QAT from the same root key PRNGKey(seed + 1) with the
    surrogate noise of every effect on, so the sweep isolates what the
    chips axis buys (`run_detector` refuses `--train-chips` without
    `--det-steps`)."""
    from repro_torch import prng
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.train.det_qat import quick_qat
    if args.train_chips <= 1:
        if args.det_steps:
            return {"qat": quick_qat(det, data, args.det_steps,
                                     args.det_batch, seed=args.seed,
                                     device=dev)}
        return {"init": det.init(prng.PRNGKey(args.seed, device=dev),
                                 device=dev)}
    common = dict(seed=args.seed, key=prng.PRNGKey(args.seed + 1, device=dev),
                  cfg_ni=NonidealConfig.all(), device=dev)
    return {
        "single": quick_qat(det, data, args.det_steps, args.det_batch,
                            train_chips=1, **common),
        f"ens{args.train_chips}": quick_qat(
            det, data, args.det_steps, args.det_batch,
            train_chips=args.train_chips,
            resample_every=args.resample_every, **common)}


def run_detector(args) -> dict:
    """Population mAP@0.5 per checkpoint and ablation column; prints a
    table per checkpoint, returns the report (`results[checkpoint]
    [column]`)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.device import get_device_model
    from repro_torch.kernels import ops
    from repro_torch.mc.detector_mc import run_mc_detector
    from repro_torch.mc.engine import McConfig, TABLE2_ABLATION
    from repro_torch.models.detector import IRCDetector
    from repro_torch.obs import PhaseTimer
    from repro_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    columns = _ablation_columns(args.ablation, TABLE2_ABLATION)
    ts = _parse_t_days(args.t_days)
    if args.train_chips > 1 and not args.det_steps:
        raise SystemExit("--train-chips needs --det-steps > 0 "
                         "(it compares QAT'd checkpoints)")
    obs = _make_runlog(args)
    cfg = yolo_irc.smoke(args.det_scheme)
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides,
                                  n_classes=cfg.n_classes,
                                  n_anchors=cfg.n_anchors)
    ops.reset_launches()
    qat_timer = PhaseTimer("qat", unit="checkpoints")
    with qat_timer.lap() as lap:
        checkpoints = _train_checkpoints(args, det, data, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lap.items = len(checkpoints)
    qat_timer.log_to(obs, det_steps=args.det_steps,
                     train_chips=args.train_chips)
    qat_s = qat_timer.total_s
    qat_launches = dict(ops.LAUNCHES)
    calib = data.batch_for_step(999, args.det_batch * 4)
    ev = data.batch_for_step(1000, args.det_batch)
    images = torch.from_numpy(ev.images).to(dev)
    key = prng.PRNGKey(args.seed, device=dev)
    mc = McConfig(n_chips=args.chips, chunk_size=args.chunk)
    use_kernel = DET_BACKENDS[args.det_backend]

    print(f"# detector {args.det_scheme} {cfg.img_hw[0]}x{cfg.img_hw[1]} "
          f"batch={args.det_batch} chips={args.chips} chunk={args.chunk} "
          f"qat_steps={args.det_steps} train_chips={args.train_chips} "
          f"backend={args.det_backend} "
          f"device={dev} pipeline={not args.no_pipeline} "
          f"device_model={args.device_model} "
          f"t_days={','.join(f'{t:g}' for t in ts)}")
    print(f"# qat {qat_s:.2f}s, kernel launches {json.dumps(qat_launches)}")
    ops.reset_launches()
    results = {}
    csv_lines = ["checkpoint,config,map50_mean,map50_std,drop_vs_ideal,"
                 "q05,q50,q95,chips,chips_per_s,compile_s,"
                 "device_model,t_days"]
    for ck, params in checkpoints.items():
        params = det.calibrate_bn(params,
                                  torch.from_numpy(calib.images).to(dev))
        print(f"# checkpoint {ck}")
        _header("map50")
        results[ck] = {}
        for t in ts:
            device = get_device_model(args.device_model, t_days=t)
            sweeps = {}
            for name, cfg_ni in columns:
                obs.log_event("ablation_column", checkpoint=ck, column=name,
                              device_model=args.device_model, t_days=t)
                sweeps[_age_label(name, t, ts)] = run_mc_detector(
                    key, det, params, images, ev.boxes, ev.classes,
                    mc=dataclasses.replace(mc, cfg=cfg_ni, device=device),
                    obs=obs, stderr_target=args.stderr_target,
                    pipeline=not args.no_pipeline, use_kernel=use_kernel)
            # the drop is measured against the same age's simulated ideal
            ideal = sweeps[_age_label("ideal", t, ts)].metrics[
                "map50"]["mean"]
            results[ck].update(_table(sweeps, "map50", ideal,
                                      args.device_model, t))
            for label, res in sweeps.items():
                m = res.metrics["map50"]
                csv_lines.append(f"{ck},{label}," + _csv_row(
                    m, ideal - m["mean"], res, args.device_model, t))
                obs.save_array(f"per_chip_map50_{ck}_{label}",
                               res.per_chip["map50"])
    _write_csv(args, obs, csv_lines)
    report = _finish(args, obs, {"args": vars(args),
                                 "run_id": obs.manifest.get("run_id"),
                                 "qat_s": qat_s,
                                 "qat_kernel_launches": qat_launches,
                                 "results": results})
    obs.finalize(status="ok", network="detector",
                 device_model=args.device_model, t_days=ts)
    return report


def main(argv=None) -> None:
    """Parse arguments, refuse flags of the other network level, and run
    the layer or the detector sweep."""
    ap = argparse.ArgumentParser(
        description="chip-ensemble Monte Carlo sweep (PyTorch/CUDA port)")
    ap.add_argument("--network", default="layer",
                    choices=["layer", "detector"],
                    help="layer: one IRC layer, bit-agreement proxy; "
                         "detector: whole-network mAP@0.5 population sweep")
    ap.add_argument("--det-scheme", default="ternary",
                    choices=["ternary", "binary"],
                    help="detector design: proposed ternary | baseline "
                         "binary (in-memory BN, partial sums)")
    ap.add_argument("--det-batch", type=int, default=2,
                    help="detector eval batch size")
    ap.add_argument("--det-steps", type=int, default=0,
                    help="QAT steps before the detector sweep (0: sweep "
                         "the initial weights)")
    ap.add_argument("--train-chips", type=int, default=1,
                    help="> 1: compare single-draw with ensemble-aware QAT "
                         "over this many chips (needs --det-steps > 0)")
    ap.add_argument("--resample-every", type=int, default=1,
                    help="QAT steps between chip-population resamples")
    ap.add_argument("--det-backend", default="auto",
                    choices=list(DET_BACKENDS),
                    help="detector group-conv routing: auto follows the "
                         "autotuner's table for this card (untuned: the "
                         "kernel), kernel forces the fused IRC MVM, jnp "
                         "(or its alias plain) the plain batched route")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="detector: serial chunk loop instead of the "
                         "overlapped one")
    ap.add_argument("--chips", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--fan-in", type=int, default=540)
    ap.add_argument("--n-out", type=int, default=60)
    ap.add_argument("--density", type=float, default=0.5,
                    help="activated word-line fraction")
    ap.add_argument("--scheme", default="ternary",
                    choices=["ternary", "binary"],
                    help="proposed ternary | baseline binary mapping")
    ap.add_argument("--bias-rows", type=int, default=32)
    ap.add_argument("--accumulation", default="single_shot",
                    choices=["single_shot", "partial_sum"])
    ap.add_argument("--backend", default="plain", choices=["plain", "kernel"],
                    help="layer forward: plain batched route, or the fused "
                         "IRC MVM kernel (single-shot only)")
    ap.add_argument("--calibrate", action="store_true",
                    help="per-die extra-bias calibration before evaluation")
    ap.add_argument("--ablation", default="all",
                    help="'table2' for the full effect sweep, or one column "
                         "name (ideal|devvar|devvar+nl|devvar+nl+peri|all)")
    ap.add_argument("--device-model", default="analytic",
                    choices=["analytic", "measured"],
                    help="device backend the chips are sampled from: the "
                         "paper's closed forms, or the packaged measured "
                         "table")
    ap.add_argument("--t-days", default="0",
                    help="comma list of deployment ages in days; each age "
                         "wraps the backend in a retention-drift timeline "
                         "and repeats the sweep (e.g. '0,30,365')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--json", default="", help="write the report here")
    ap.add_argument("--run-dir", default="experiments",
                    help="root of the <run_id>/ run directory (manifest, "
                         "metrics.jsonl, per-chip .npy, results.csv; '' "
                         "disables)")
    ap.add_argument("--run-id", default="",
                    help="explicit run id (default: timestamped)")
    ap.add_argument("--out", default="",
                    help="machine-readable CSV path (default "
                         "<run_dir>/results.csv)")
    ap.add_argument("--stderr-target", type=float, default=None,
                    help="stop each sweep once the standard error of the "
                         "mean reaches this target")
    ap.add_argument("--trace", action="store_true",
                    help="capture a torch.profiler trace into the run dir")
    args = ap.parse_args(argv)

    # flags of the other network level would be silently ignored: refuse
    # them rather than write a report whose args misstate the run
    other = (("scheme", "fan_in", "n_out", "density", "bias_rows",
              "accumulation", "backend", "calibrate", "batch")
             if args.network == "detector"
             else ("det_scheme", "det_batch", "det_steps", "train_chips",
                   "resample_every", "det_backend", "no_pipeline"))
    misused = [f"--{n.replace('_', '-')}" for n in other
               if getattr(args, n) != ap.get_default(n)]
    if misused:
        raise SystemExit(f"--network {args.network} does not take "
                         f"{', '.join(misused)}")
    if args.network == "layer":
        run_layer(args)
        return
    run_detector(args)


if __name__ == "__main__":
    main()
