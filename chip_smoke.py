#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py              # every phase; exits 0 only if all pass

Phases, each printing its own lines:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: compiles src/repro_torch/csrc/irc_mvm.cu for sm_90a;
  3. kernel against its plain PyTorch version at the detector's full-width
     shapes (shared/per-chip word lines and placement planes, binary and
     diff outputs, all effects on and off; the single-chip case too);
  4. times with CUDA events: kernel, plain version, a torch.bmm yardstick of
     the same four products, and the card's bound for the same work;
  5. the main path: `run_ablation_detector` on `yolo_irc.proposed()` at full
     width (random init, 16 chips in chunks of 4, 2 images, columns ideal
     and all), with the kernel's launch count checked; then the single-chip
     layer path `irc_mvm_from_mapped`;
  6. one whole-network chunk through the kernel and through the plain route;
  7. the CLI `python -m repro_torch.launch.mc --network detector --chips 4`;
  8. a JSON line of every ported kernel, the card's name and power limit,
     and the final `{"ok": true, ...}` line.
`--only profile` instead breaks one full-width chunk's device time down by
kernel (torch.profiler); it is a measurement, not part of the smoke run.
It exits non-zero, printing no result, when no CUDA device is visible or
when the repository's sources are missing beside it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Card peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12          # FFMA, outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # tensor cores, f32 operands

# full-width geometry of yolo_irc.proposed(): 576x1024 images, stem /2
S0_ROWS_PER_IMAGE = 288 * 512
S1_ROWS_PER_IMAGE = 144 * 256
R_ROWS, N_COLS, BIAS_ROWS = 572, 60, 32


def log(phase: str, msg: str) -> None:
    """One line of a phase's report."""
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    """Fail the run (an exception, whatever python's -O says)."""
    if not ok:
        raise RuntimeError(msg)


def gpu_name_and_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for GPU 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of `fn()` on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(C: int, B: int, per_chip_x: bool, per_chip_g: bool, gen):
    """Random full-width operands of one group conv: ternary 20/60/20
    placement planes with the 32 bias rows, log-normal effective planes with
    the HRS leak, word-line bits at density 0.5 behind the bias rows, and
    the periphery noise."""
    import torch
    from repro_torch.core.mapping import ternary_planes
    from repro_torch.core.ternary import ternary_quantize
    dev = gen.device
    n_planes = C if per_chip_g else 1
    gps, gns = [], []
    for _ in range(n_planes):
        w = torch.randn((R_ROWS - BIAS_ROWS, N_COLS), generator=gen,
                        device=dev)
        m = ternary_planes(ternary_quantize(w, axis=(0,)), BIAS_ROWS)
        gps.append(m.g_pos)
        gns.append(m.g_neg)
    gp = torch.stack(gps) if per_chip_g else gps[0]
    gn = torch.stack(gns) if per_chip_g else gns[0]

    def eff(g):
        mask = torch.exp(0.4245 * torch.randn((C, R_ROWS, N_COLS),
                                              generator=gen, device=dev))
        return (g * mask + (1.0 - g) * 1e-4).contiguous()

    ep, en = eff(gp), eff(gn)
    lead = (C,) if per_chip_x else ()
    bits = (torch.rand(lead + (B, R_ROWS - BIAS_ROWS), generator=gen,
                       device=dev) < 0.5).float()
    x = torch.cat([torch.ones(lead + (B, BIAS_ROWS), device=dev), bits], -1)
    del bits
    eps = torch.randn((C, B, N_COLS), generator=gen, device=dev)
    rnd = (torch.rand((C, B, N_COLS), generator=gen, device=dev)
           < 0.5).float()
    return x, ep, en, gp, gn, eps, rnd


def check_layout(tag, ops_, C, B, per_chip_x, per_chip_g, gen):
    """Kernel vs plain version on one layout: counts exact, diff within
    1e-3, binary flips only at near-ties.  Returns (max |diff error|,
    near-tie flips)."""
    import torch
    from repro_torch.kernels.ref import (IrcEpilogueParams,
                                         irc_mvm_chips_ref, near_tie_flips,
                                         NEAR_TIE_TOL)
    from repro_torch.core.macro import DEFAULT_MACRO
    x, ep, en, gp, gn, eps, rnd = make_case(C, B, per_chip_x, per_chip_g,
                                            gen)
    single = C == 1 and not per_chip_x and not per_chip_g

    def run(params, a, b, c, d):
        if single:
            return ops_.irc_mvm(x, a[0], b[0], c, d, eps[0], rnd[0],
                                params)[None]
        return ops_.irc_mvm_chips(x, a, b, c, d, eps, rnd, params)

    off = dict(apply_nonlinearity=False, apply_ir=False, apply_sa=False,
               apply_range=False)
    # counts: with e+ := g+ (e- := 0) and every effect off, the diff output
    # is the activated-LRS count p+ (and -p- the other way), exact integers
    p_diff = IrcEpilogueParams.from_macro(DEFAULT_MACRO, output="diff", **off)
    zeros = torch.zeros_like(ep)
    gpc = gp.expand(ep.shape).contiguous()
    gnc = gn.expand(en.shape).contiguous()
    for a, b, sign, g in ((gpc, zeros, 1.0, gp), (zeros, gnc, -1.0, gn)):
        got = run(p_diff, a, b, gp, gn)
        want = sign * (x @ g).expand(got.shape)
        check(torch.equal(got, want), f"{tag}: counts differ")
    del gpc, gnc, zeros
    worst, flips = 0.0, 0
    for effects in ("all", "none"):
        eff = {} if effects == "all" else off
        for output in ("diff", "binary"):
            params = IrcEpilogueParams.from_macro(DEFAULT_MACRO,
                                                  output=output, **eff)
            got = run(params, ep, en, gp, gn)
            want, margin = irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd,
                                             params, margin=True)
            if output == "diff":
                # f32 sums in another order: 18 IR blocks of up to ~300
                # units, a few ulps (3e-5 each) apart
                err = float((got - want).abs().max())
                check(err <= 1e-3, f"{tag} {effects} diff err {err}")
                worst = max(worst, err)
                same = float((got == want).float().mean())
                log("3 kernels", f"{tag} {effects}: diff bit-identical to "
                    f"the plain version on {same:.6f} of outputs")
            else:
                n, ok = near_tie_flips(got, want, margin)
                check(ok, f"{tag} {effects}: {n} binary flips, not all "
                      f"within margin {NEAR_TIE_TOL}")
                flips += n
            del got, want, margin
    torch.cuda.synchronize()
    return worst, flips


def phase_kernels(ops_):
    """Phase 3: the kernel against its plain version at full width."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    B0 = 2 * S0_ROWS_PER_IMAGE
    B1 = 2 * S1_ROWS_PER_IMAGE
    cases = (("s0b0 shared x, shared g", 4, B0, False, False),
             ("s0b1 per-chip x, shared g", 4, B0, True, False),
             ("s1 per-chip x, per-chip g", 4, B1, True, True),
             ("K2 single chip C=1", 1, B0, False, False))
    report = {}
    for tag, C, B, pcx, pcg in cases:
        t0 = time.perf_counter()
        err, flips = check_layout(tag, ops_, C, B, pcx, pcg, gen)
        report[tag] = (err, flips)
        log("3 kernels", f"{tag}: C={C} B={B} R={R_ROWS} N={N_COLS} "
            f"counts exact, max|diff err|={err:.3g} (tol 1e-3), "
            f"near-tie binary flips={flips} "
            f"({time.perf_counter() - t0:.1f}s)")
        torch.cuda.empty_cache()
    return report


def bound_ms(C, B, R, N, per_chip_x, per_chip_g):
    """Least time for the work: each input read once and the output written
    once at the memory rate, against the operations at the peak of their
    type.  The two block-current products x.e+- (multiply + add) are f32 and
    need FFMA; the two counts x.g+- have both operands in {0,1}, which the
    tensor cores sum exactly, so they go at the TF32 rate.  Returns (ms,
    "bytes" | "operations")."""
    nbytes = 4 * ((C if per_chip_x else 1) * B * R
                  + 2 * C * R * N + 2 * (C if per_chip_g else 1) * R * N
                  + 3 * C * B * N)
    flops_per_product = 2 * C * B * R * N
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (2 * flops_per_product / PEAK_F32_FLOPS
             + 2 * flops_per_product / PEAK_TF32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bmm_yardstick(x, ep, en, gp):
    """The same four products (block currents of both planes per 32-row IR
    block, and both counts) as batched torch.bmm calls; a timing yardstick
    only, never called by the port."""
    import torch
    import torch.nn.functional as F
    C, R, N = ep.shape
    B = x.shape[-2]
    pad = (-R) % 32
    nb = (R + pad) // 32
    xp = F.pad(x, (0, pad)).expand(C, B, R + pad)
    xb = xp.reshape(C, B, nb, 32).permute(0, 2, 1, 3).reshape(C * nb, B, 32)
    epb = F.pad(ep, (0, 0, 0, pad)).reshape(C * nb, 32, N)
    enb = F.pad(en, (0, 0, 0, pad)).reshape(C * nb, 32, N)
    gpp = F.pad(gp, (0, 0, 0, pad)).expand(C, R + pad, N).contiguous()
    gnp = gpp.clone()
    xpc = xp.contiguous()

    def run():
        torch.bmm(xb, epb)
        torch.bmm(xb, enb)
        torch.bmm(xpc, gpp)
        torch.bmm(xpc, gnp)
    return run


def phase_times(ops_):
    """Phase 4: kernel, plain and yardstick times at the main path's
    largest shape (s0b1) and, for K2, one chip at the s0 shape."""
    import torch
    from repro_torch.core.macro import DEFAULT_MACRO
    from repro_torch.kernels.ref import IrcEpilogueParams, irc_mvm_chips_ref
    gen = torch.Generator(device="cuda").manual_seed(99)
    params = IrcEpilogueParams.from_macro(DEFAULT_MACRO)
    params_diff = IrcEpilogueParams.from_macro(DEFAULT_MACRO, output="diff")
    out = {}
    for name, C, pcx in (("irc_mvm_chips", 4, True), ("irc_mvm", 1, False)):
        B = 2 * S0_ROWS_PER_IMAGE
        x, ep, en, gp, gn, eps, rnd = make_case(C, B, pcx, False, gen)
        if name == "irc_mvm":
            kern = lambda: ops_.irc_mvm(x, ep[0], en[0], gp, gn, eps[0],
                                        rnd[0], params)
            d_k = ops_.irc_mvm(x, ep[0], en[0], gp, gn, eps[0], rnd[0],
                               params_diff)[None]
        else:
            kern = lambda: ops_.irc_mvm_chips(x, ep, en, gp, gn, eps, rnd,
                                              params)
            d_k = ops_.irc_mvm_chips(x, ep, en, gp, gn, eps, rnd,
                                     params_diff)
        d_p = irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd, params_diff)
        err = float((d_k - d_p).abs().max())
        del d_k, d_p
        plain = lambda: irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd, params)
        ms = cuda_ms(kern, reps=7)
        plain_ms = cuda_ms(plain, reps=3)
        lib_ms = cuda_ms(bmm_yardstick(x, ep, en, gp), reps=5)
        b_ms, b_by = bound_ms(C, B, R_ROWS, N_COLS, pcx, False)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        log("4 times", f"{name} C={C} B={B} R={R_ROWS} N={N_COLS}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bmm yardstick "
            f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
            f"share of bound {b_ms / ms:.3f}")
        del x, ep, en, gp, gn, eps, rnd
        torch.cuda.empty_cache()
    return out


def phase_main_path(ops_):
    """Phase 5: Table II at full width through the kernel, then the
    single-chip layer path; returns the launch counts of each."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.core.crossbar import crossbar_forward
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.detector_mc import run_ablation_detector
    from repro_torch.mc.engine import McConfig, TABLE2_ABLATION
    from repro_torch.models.detector import IRCDetector

    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides,
                                  n_classes=cfg.n_classes,
                                  n_anchors=cfg.n_anchors)
    params = det.init(torch.Generator().manual_seed(0), device="cuda")
    calib = data.batch_for_step(999, 8)
    params = det.calibrate_bn(params,
                              torch.from_numpy(calib.images).cuda())
    ev = data.batch_for_step(1000, 2)
    images = torch.from_numpy(ev.images).cuda()
    key = prng.PRNGKey(0, device="cuda")
    # 4 chunks: every steady lap but the last enqueues the next chunk
    n_chips, chunk = 16, 4
    columns = tuple(c for c in TABLE2_ABLATION if c[0] in ("ideal", "all"))
    mc = McConfig(n_chips=n_chips, chunk_size=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_.reset_launches()
    t0 = time.perf_counter()
    results = run_ablation_detector(key, det, params, images, ev.boxes,
                                    ev.classes, ablations=columns, mc=mc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops_.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, res in results.items():
        m = res.metrics["map50"]
        check(np.isfinite(res.per_chip["map50"]).all()
              and res.n_chips == n_chips, f"{name}: bad population result")
        log("5 main path", f"{name}: map50 {m['mean']:.4f}±{m['std']:.4f} "
            f"over {res.n_chips} chips, {res.chips_per_sec:.4f} chips/s "
            f"steady, {res.n_chips / res.wall_s:.4f} chips/s overall, "
            f"wall_s {res.wall_s:.3f}, first chunk {res.compile_s:.3f}s, "
            f"enqueue_s {res.enqueue_s:.3f}, device_s {res.device_s:.3f}, "
            f"host_s {res.host_s:.3f}")
    n_chunks = -(-n_chips // chunk)
    want = 14 * n_chunks * len(columns)
    log("5 main path", f"yolo_irc.proposed() 576x1024, 2 images, {n_chips} "
        f"chips in chunks of {chunk}, columns {[c[0] for c in columns]}: "
        f"wall {wall:.2f}s, peak device memory {peak:.2f} GiB, kernel "
        f"launches {launches} (want irc_mvm_chips = 14 x {n_chunks} x "
        f"{len(columns)} = {want})")
    check(launches["irc_mvm_chips"] == want, f"launches {launches}")

    # single-chip layer path (K2): one s0b1 group conv of one chip
    blk = params["s0b1"]
    mapped = det.group_mappings(blk, 60, 60)[0]
    xs = (torch.rand((2 * S0_ROWS_PER_IMAGE, 540), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))
          < 0.5).float()
    from repro_torch.kernels.ops import irc_mvm_from_mapped
    ops_.reset_launches()
    k1 = prng.fold_in(key, 11)
    got = irc_mvm_from_mapped(k1, xs, mapped, NonidealConfig.all(),
                              det.spec)
    torch.cuda.synchronize()
    single_launches = dict(ops_.LAUNCHES)
    want_single = crossbar_forward(k1, xs, mapped, cfg=NonidealConfig.all(),
                                   spec=det.spec)
    agree = float((got == want_single).float().mean())
    log("5 layer path", f"irc_mvm_from_mapped s0b1 group, B={xs.shape[0]}: "
        f"launches {single_launches}, agreement with crossbar_forward "
        f"{agree:.6f}")
    check(single_launches["irc_mvm"] == 1 and agree >= 0.999,
          f"layer path: launches {single_launches}, agreement {agree}")
    return launches, single_launches


def phase_network(ops_):
    """Phase 6: one full-width chunk (2 chips x 1 image) through the kernel
    route and through the plain route: head agreement >= 99% within 1e-4
    and per-chip mAP within 0.02."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.detector_mc import (_sample_and_forward,
                                            detector_planes)
    from repro_torch.models.detector import IRCDetector
    from repro_torch.train.det_loss import evaluate_map_per_chip
    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides)
    params = det.init(torch.Generator().manual_seed(1), device="cuda")
    params = det.calibrate_bn(
        params, torch.from_numpy(data.batch_for_step(7, 4).images).cuda())
    ev = data.batch_for_step(8, 1)
    images = torch.from_numpy(ev.images).cuda()
    planes, meta = detector_planes(det, params)
    key = prng.PRNGKey(3, device="cuda")
    ids = torch.arange(2, device="cuda")
    outs = {}
    for impl in ("kernel", "ref"):
        outs[impl] = _sample_and_forward(
            params, images, key, ids, planes, det_cfg=cfg, spec=det.spec,
            cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta,
            kernel_impl=impl).cpu().numpy()
        torch.cuda.empty_cache()
    a, b = outs["kernel"], outs["ref"]
    check(a.shape == b.shape == (2, 1) + det.head_geometry()
          and np.isfinite(a).all(), f"bad head output {a.shape}")
    frac = float(np.mean(np.abs(a - b) <= 1e-4))
    maps = [evaluate_map_per_chip(o, ev.boxes, ev.classes, cfg.n_anchors,
                                  cfg.n_classes) for o in (a, b)]
    dmap = float(np.max(np.abs(maps[0] - maps[1])))
    log("6 network", f"2 chips x 1 image, kernel vs plain route: head "
        f"agreement {frac:.6f} (>= 0.99), per-chip mAP {maps[0].tolist()} "
        f"vs {maps[1].tolist()} (max diff {dmap:.4f} <= 0.02)")
    check(frac >= 0.99 and dmap <= 0.02,
          f"network: agreement {frac}, mAP diff {dmap}")


def phase_profile():
    """`--only profile`: where one full-width chunk's device time goes (4
    chips x 2 images, all effects): the chunk's span on CUDA events and
    torch.profiler's device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.detector_mc import (_sample_and_forward,
                                            detector_planes)
    from repro_torch.models.detector import IRCDetector
    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides)
    params = det.init(torch.Generator().manual_seed(0), device="cuda")
    params = det.calibrate_bn(
        params, torch.from_numpy(data.batch_for_step(999, 8).images).cuda())
    images = torch.from_numpy(data.batch_for_step(1000, 2).images).cuda()
    planes, meta = detector_planes(det, params)
    key = prng.PRNGKey(0, device="cuda")
    ids = torch.arange(4, device="cuda")

    def chunk():
        return _sample_and_forward(
            params, images, key, ids, planes, det_cfg=cfg, spec=det.spec,
            cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta)

    ms = cuda_ms(chunk, reps=3)
    t0 = time.perf_counter()
    chunk()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    log("9 profile", f"one chunk (4 chips x 2 images, all effects): "
        f"{ms:.2f} ms device span (CUDA events, median of 3), host enqueue "
        f"{enqueue_s * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device kernels only: the aten:: rows repeat their kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if not e.key.startswith("aten::") and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows)
    if total <= 0:
        log("9 profile", "the profiler saw no device time: breakdown not "
            "measured")
        return
    irc = sum(dev_us(e) for e in rows if "irc_mvm_chips_kernel" in e.key)
    int64 = sum(dev_us(e) for e in rows if "<long" in e.key)
    log("9 profile", f"device kernels {total / 1e3:.2f} ms in "
        f"{sum(e.count for e in rows)} launches: irc_mvm_chips "
        f"{irc / 1e3:.2f} ms ({100 * irc / total:.1f}%), int64 elementwise "
        f"(threefry) {int64 / 1e3:.2f} ms ({100 * int64 / total:.1f}%), "
        f"rest {(total - irc - int64) / 1e3:.2f} ms")
    for e in rows[:12]:
        log("9 profile", f"{dev_us(e) / 1e3:9.2f} ms "
            f"{100 * dev_us(e) / total:5.1f}%  x{e.count:<5d} {e.key[:90]}")


def phase_cli():
    """Phase 7: the CLI runs to its end on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mc", "--network",
         "detector", "--chips", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-4:]
    for line in tail:
        log("7 cli", line)
    check(proc.returncode == 0, proc.stderr[-2000:])
    log("7 cli", f"exit 0 in {time.perf_counter() - t0:.1f}s")


PHASES = ("kernels", "times", "main", "network", "cli")


def main(argv=None) -> int:
    """Run the phases (all by default); any failure propagates and exits
    non-zero.  `--only kernels,times` runs a subset while iterating; only a
    run of every phase prints the result lines."""
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma list of phases to run, of {PHASES}, plus "
                         "'profile' (device-time breakdown of one chunk, "
                         "never run by default)")
    only = set(ap.parse_args(argv).only.split(","))
    unknown = only - set(PHASES) - {"profile"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "irc_mvm.cu").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    card = gpu_name_and_limit()
    log("1 env", f"python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}; gpu: {card}")

    from repro_torch.kernels import irc_mvm, ops
    irc_mvm.load()
    log("2 build", f"nvcc sm_90a build of {irc_mvm.SOURCE.name}: "
        f"{irc_mvm.BUILD_S:.1f}s into {irc_mvm.build_dir()}")
    for line in irc_mvm.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("2 build", "ptxas: " + line.strip())

    checks = phase_kernels(ops) if "kernels" in only else {}
    times = phase_times(ops) if "times" in only else {}
    launches, single = (phase_main_path(ops) if "main" in only
                        else ({}, {}))
    if "network" in only:
        phase_network(ops)
    if "cli" in only:
        phase_cli()
    if "profile" in only:
        phase_profile()
    if only != set(PHASES):
        log("8 summary", f"ran phases {sorted(only)} only; no result")
        return 1

    kernels = []
    for name, replaces, n in (
            ("irc_mvm_chips", "src/repro/kernels/irc_mvm.py:228",
             launches["irc_mvm_chips"]),
            ("irc_mvm", "src/repro/kernels/irc_mvm.py:184",
             single["irc_mvm"])):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/irc_mvm.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    flips = sum(f for _, f in checks.values())
    log("8 summary", f"near-tie binary flips in phase 3: {flips}; total "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
