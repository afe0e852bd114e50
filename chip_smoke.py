#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py              # every phase; exits 0 only if all pass

Phases, each printing its own lines:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: compiles src/repro_torch/csrc/{irc_mvm,ternary_matmul,
     flash_attention,xla_math,threefry}.cu for sm_90a, one nvcc process
     each, all started together; fails if ptxas spills in any kernel (K1
     at each of its row tiles among them) or serializes the wgmmas of
     (C7520) the tensor-core kernels (K3, K4);
  3. kernels against their plain PyTorch versions: the IRC MVM (K1/K2) at
     the detector's full-width shapes (shared/per-chip word lines and
     placement planes, binary and diff outputs, all effects on and off; the
     single-chip case too), at 28 ragged shapes across the kernel's tile
     edges (R from 32 to 1,024 rows, N from 1 to 100, B from 1 to 1,000) and
     with word lines that are not all 0 or 1, bit-identical; the ternary
     matmul (K3) at shapes across its tiles, splits over K and load paths
     (TMA, cp.async, 2-byte loads; each line names the plan) and the layer
     path's, {0,1} inputs bit-identical, normal and bfloat16 inputs within
     the JAX package's tolerances, also with x 4 and 2 bytes off 16-byte
     alignment and with +-Inf, NaN, +-3e38 and subnormals in x (non-finite
     outputs where the plain version's are); causal flash attention (K4) at
     the JAX package's test
     shapes, a ragged Sq > Sk case, two shapes ragged at the bf16 leg's TMA
     box edges (4x1000x1000x128, 2x4096x1000x64) and chameleon-34b's
     attention layer (64 heads x 4096 x 128), float32 and bfloat16, within
     the JAX package's tolerances (bfloat16 also row by row within one bf16
     rounding), also with operands 4 (float32) and 2 bytes (bfloat16) off
     16-byte alignment; the elementwise kernels of XLA's float32 math (fused
     multiply-add, erf_inv, exp) at the main paths' shapes, the fused
     multiply-add on each of its paths (float4, 32-bit, 64-bit; broadcast,
     strided, scalar, 0-dim, misaligned), bit-identical; the die-sampling
     kernel (threefry) in every mode (fold_in, split, bits, uniform, normal,
     log-normal mask, bernoulli) under both threefry schemes at the first
     layer's periphery draw [4, 294912, 60], the variation masks, odd and
     single-word draws, one and several keys, bit-identical to the int64
     plain version;
  4. times with CUDA events: each kernel, its plain version, a library
     yardstick (torch.bmm of the IRC MVM's four products; torch.matmul in
     true f32 for K3; scaled_dot_product_attention, TF32 off, for K4;
     torch.addcmul, erfinv and exp for the elementwise kernels; torch.randn
     with a CUDA generator for the die sampling) and the card's bound for
     the same work (K3: 3 bf16 tensor-core passes for f32 x, 1 for bf16
     x, and a check that its SASS holds HGMMA; K4: QK^T 1 + PV 3 bf16
     tensor-core passes for bf16 inputs, 6 + 6 for f32 (bf16x6), each
     leg's rate on that work and a check that its own SASS function holds
     HGMMA; for f32 the split pre-pass alone and the FFMA bound beside, for
     bf16 sdpa f32 on the upcast inputs as the same-precision yardstick);
     the calls of all but K1/K2 are queued
     behind a sleep kernel so that the events hold device time only, and
     the host's enqueue time per call is printed on its own line;
  5. the main paths: `run_ablation_detector` on `yolo_irc.proposed()` at
     full width (random init, 12 chips in chunks of 4, 2 images, columns
     ideal and all), with K1's launch count checked; the single-chip layer
     path `irc_mvm_from_mapped` (K2); the layer-level Table II
     (`run_ablation`, all five columns, 540x60 layer, batch 256, 2048 dies
     in chunks of 512) for the proposed design through K1 and the baseline
     through the plain route, each with its ideal reference bits through
     K3, launch counts checked; the op `ops.flash_attention` at
     chameleon-34b's attention shape (K4, one count per call: the f32
     call's two CUDA launches, split and attention, count once); the
     baseline design `yolo_irc.baseline()` at full width through
     `run_ablation_detector`, all five Table II columns, on the plain
     route (no K1 launch, as in the reference); every path that samples
     dies must launch the threefry kernel (and no longer the erf_inv and
     exp kernels), and the plain route's paths the fused multiply-add too;
     the QAT path of `yolo_irc.proposed()` at full width, 2 images: K1 on
     the ensemble step's deviation planes (signed, every effect off,
     output="diff", per-chip word lines) bit-identical to its plain
     version, one single-draw step's loss and gradients on the card against
     the same step on the CPU, the single-draw and 2-chip ensemble steps
     timed with launches per step and peak memory, and `quick_qat` over 3
     ensemble steps with its launches counted from 0 (K1 14 a step); the
     detector sweep's `stderr_target` stop, serial and pipelined at the
     same chunk boundary with the full run's per-chip maps; and (`--only
     serve`) the detector service `DetectorServeEngine` on
     `yolo_irc.proposed()` at full width, committee 4, 2 slots: 6 requests
     through the background scheduler (K1 14 a request, threefry),
     requests/s steady and overall, device and host seconds per wave,
     queue p50/p95, peak memory, then K1's count per wave and one
     request's committee bit-identical to the MC chunk forward at its key
     and within the near-tie bar of K1's plain version;
  6. one whole-network chunk through the kernel and through the plain
     route; 512-die layer chunks through both routes (proposed, calibrated
     per-chip planes, binary single-shot), flips only at near-ties;
  autotune (`--only autotune` runs it alone): K1's row tiles and the
     detector's routing: every candidate tile (`irc_mvm.TILES`)
     bit-identical to K1's plain version at phase 3's full-width and 28
     ragged shapes; the autotuner's sweep (CUDA events) of the proposed
     design's chunk (4 chips x 2 images) and wave (committee 4 x 1 image)
     problems into a temporary table, never the committed one: each tile
     and the plain route timed whole, each tile's bare K1 launch beside its
     bound and the four-bmm yardstick, and the winner per problem against
     the committed entry for this card; then `run_ablation_detector` at
     full width (4 chips, one chunk, ideal and all) under `use_kernel`
     None, True and False: K1 launched exactly where the committed table
     routes it (none under False, 14 a chunk under True), per-chip mAPs of
     the three within 0.02.  The phases before it (3, 5, 6, serve) and
     `devices` pass `use_kernel=True` and hold K1 whatever the table says;
  7. the CLIs `python -m repro_torch.launch.mc --network detector --chips 4`
     (the proposed design, at `--det-backend` auto, plain and kernel, with
     per-chip mAPs within 0.02; the baseline, `--det-scheme binary
     --ablation table2`), `--network layer --chips 64 --ablation table2
     --backend kernel`, and the detector after QAT, `--chips 16 --ablation
     table2 --det-steps 3` (and 20) and `--chips 16 --det-steps 2
     --train-chips 2`, each into a run directory under a temporary one
     (the layer's checked for manifest.json, metrics.jsonl and
     results.csv), and `python -m repro_torch.launch.serve --network
     detector --requests 6 --slots 2 --committee 4 --det-backend kernel
     --trace`, whose torch.profiler trace must hold a CUDA kernel event of
     K1; the nine processes run side by side;
  devices (`--only devices` runs it alone): the measured device backend
     and retention drift: the threefry kernel's measured tail on all 2^23
     of its inputs, in order and shuffled, bit-identical to its plain
     version, for the packaged table and each of `MEASURED_TABLES`; the
     measured draw (bit-identical to its plain version with two tables)
     timed at the periphery shape and at one 512-die layer mask beside
     torch.randn + torch.special.ndtr and its bound per pipe, with the
     tail's SASS per word by class (no constant loaded a word) and, with
     `--threefry-baseline`, other builds of threefry.cu in turns; the
     pairs launch (fold_in) at 4 and 512 keys beside a 1-element torch
     add; the detector aging
     sweep on `yolo_irc.proposed()` at full width (2 images, 8 chips in
     chunks of 4, columns ideal and all) on the measured device at 0 and
     365 days, launches of K1, threefry and its measured tail counted for
     each age, and the analytic device at day 0 against the main path's
     per-chip mAPs; the layer CLI's sweep (540x60, 2048 dies in chunks of
     512, K1 and K3) at 0, 30 and 365 days; `IRCLinear(mode="eval")` over
     two macros card vs CPU, flips only at near-ties;
  paper (`--only paper` runs it alone): the paper's task through the
     port's twins of the JAX package's drivers (`repro_torch.examples`),
     each with the launch counts set to 0 just before it: the quickstart
     (K2 against the structural simulation, agreement >= 99%; K3; threefry),
     every row of the paper tables with a finite time (K3 and threefry;
     K1 on the proposed smoke detector's sweeps), and `train_detector
     --full --steps 4 --batch 2 --eval-batches 1 --mc-chips 2 --mc-chunk 1`
     for both designs into a temporary run directory (K1 14 a proposed
     chunk and none on the baseline, whose partial sums launch xla_fma;
     threefry on both sweeps);
  lm (`--only lm` runs it alone): the LM serving path, TF32 checked off
     first: every registered arch's smoke config, `LM.init(PRNGKey(0))`
     on the card bit-identical to the port on the CPU (threefry kernel
     against plain) and 4 decode steps within atol 1e-5 + rtol 1e-4;
     phi3-medium-14b, hymba-1.5b and rwkv6-3b at full width cut to 2
     layers in float32, drawn on the card and copied to the CPU, 4 decode
     steps at batch 2 within 1e-4 (max|ref| + |ref|), greedy agreement
     printed; qwen3-moe-235b-a22b at full width, 2 layers, float32, decode
     against the teacher-forced forward within 2e-2 and the assignments
     dropped for capacity; the threefry kernel's 3.67e9-word draw of
     phi3-medium-14b's stacked w_gate (past 2^31 words under one key)
     under both schemes, windows of 1M counters at its start, around 2^31
     and at its end held bit for bit against their plain words; `python -m
     repro_torch.launch.serve --network lm --variant full` at full width
     and depth in bfloat16 for phi3-medium-14b (8 requests, 4 slots, 16
     new tokens), hymba-1.5b and rwkv6-3b (4 requests, 8 new tokens), one
     after another (steady decode and prefill tokens/s beside the decode
     bound, first wave, peak memory, the init's threefry launches, the
     run dir); a smoke checkpoint saved by the port's CheckpointManager in
     bfloat16 and float32, restored by the CLI's `--ckpt-dir` with the
     tokens of an in-process engine on the restored params; and the CLI at
     `--temperature 0.8` with one threefry uniform launch a sampling step
     and the tokens of the engine on the CPU up to counted near-ties;
     then one phi3-medium-14b decode step at full width and depth timed
     (wall, device span, kernels' busy time) and broken down by kernel;
  train_lm (`--only train_lm` runs it alone): LM training, TF32 checked
     off first: every registered arch's smoke config with IRC off and on,
     one value_and_grad on the card (remat block) against the CPU from the
     same params (loss within 1e-5 + 1e-4|ref|, each gradient leaf within
     relative L2 1e-5 / 1e-3) and one train step on the card;
     hymba-1.5b, musicgen-medium and rwkv6-3b at full width cut to 2
     layers in float32, card against CPU the same way; xla_fma on the
     scan's first-level operands at hymba's full width and 2 x 4096 (the
     stride-2 views) bit for bit against its plain version; `python -m
     repro_torch.launch.train` at full width and depth (batch 8 x 4096,
     microbatch 4, remat block): hymba-1.5b 8 steps without checkpoints,
     then, at batch 2 x 1024, 1 step with checkpoints on disk resumed from
     them to 2 (it must start at 1; two saves of 14.75 GB) and 2 steps
     with --irc,
     musicgen-medium 3 steps, each with a `# train stats` line (steady
     steps/s and tokens/s, compile_s, peak memory, the losses, the
     model-FLOPs share) and its kernel launches (threefry; xla_fma on
     hymba); hymba-1.5b's peak memory under each remat mode at batch 1 x
     1024 and one micro-slice broken down by kernel; the examples
     `train_lm --size 100m --steps 50` and `serve_lm` at its defaults;
  dryrun (`--only dryrun` runs it alone): the mesh and dry-run tooling on
     a fake 256-rank "cuda" process group: the cost probes of
     phi3-medium-14b train_4k (L1/L2 x mb1/mb2) and qwen3-moe-235b-a22b
     decode_32k at full width, their roofline rows priced for the H100
     (per-device argument bytes, FLOPs, collectives by kind, compute /
     memory / collective seconds, trace seconds) and the FLOP inflation
     of the L1 probe (at most 1.25); every arch's smoke config traced for
     decode_32k on both meshes; then, in a subprocess, one train step of
     the hymba-1.5b and qwen3-moe smoke configs with and without
     `LM.use_mesh` on a real 1x1 NCCL mesh: the loss bit-identical and
     the xla_fma launches equal; beside all that, from the phase's start,
     `repro_torch.launch.meshcheck` on a real 2x2 gloo mesh of four CPU
     processes (the three attention modes, the MoE's expert split, a
     sequence-sharded decode cache) held to the CPU test's tolerances;
  analysis (`--only analysis` runs it alone): the static-analysis suite
     on the card: `python -m repro_torch.analysis --json` (key discipline,
     host-sync hygiene, the shape contracts on fake CUDA tensors) with zero
     findings and exit 0, its seconds per pass; every detector/MC shape
     contract on fake CUDA tensors and for real at its own sizes, the real
     leaves of the fake ones' shapes, dtypes and device (K1 and threefry
     launched on the kernel-route contracts, K1 not on the plain-route
     ones); `yolo_irc.proposed()` at full width in ensemble mode through K1
     at 4 chips and 2 images fake against real (K1 14 launches) and its
     first block's single-chip layer path (K2), every call of the fake ops'
     wrappers (K1, K2, threefry's fold_in, split and draws) replayed on
     fake tensors of its shapes against the real kernel's output;
  8. a JSON line of every ported kernel (the measured tail among them),
     the card's name and power limit, and the final `{"ok": true, ...}`
     line.
`--only profile` instead breaks one full-width chunk's device time down by
kernel (torch.profiler), with the threefry kernel's share beside what is
left of int64 elementwise ops, and so one QAT step of each kind; it is a
measurement, not part of the smoke run.
It exits non-zero, printing no result, when no CUDA device is visible or
when the repository's sources are missing beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
PEAK_BF16_FLOPS = 989e12        # tensor cores, bf16 operands
# Instructions per SM and clock by pipe, 132 SMs at the 1.98 GHz boost
# clock (the clock of PEAK_F32_FLOPS: 128 x 2 x 132 x 1.98e9).  CUDA C++
# Programming Guide, "Throughput of Native Arithmetic Instructions",
# compute capability 9.0: 32-bit integer add, shift (the funnel shift
# among them), bitwise AND/OR/XOR and compare 64 (the ALU pipe, 16 lanes a
# sub-partition); 32-bit integer multiply-add 64 (IMAD, on the FMA pipe,
# where the compiler also issues adds); 32-bit float add, multiply and
# multiply-add 128; reciprocal, exp2 and the type conversions 16 (MUFU).
# Issue: one warp instruction per sub-partition and clock, 128 per SM.
SM_CLOCKS_PER_S = 132 * 1.98e9
PIPE_RATE = {"alu": 64, "imad": 64, "fma": 128, "mufu": 16, "issue": 128}
PEAK_MUFU_OPS = PIPE_RATE["mufu"] * SM_CLOCKS_PER_S

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
    """Median milliseconds of one `fn()` on the current stream (CUDA
    events)."""
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


def queued_ms(fn, reps: int, calls: int) -> tuple:
    """(median device milliseconds of one `fn()`, host milliseconds to
    enqueue one).  Each rep queues `calls` back-to-back calls behind a sleep
    kernel that outlasts their enqueue, so the CUDA events around them see
    the device's time only; a rep whose enqueue outran its sleep is redone
    with a longer sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    probe[1].synchronize()
    cycles_per_ms = 10_000_000 / probe[0].elapsed_time(probe[1])
    sleep_ms = 3 * host_ms * calls + 0.5
    times = []
    while len(times) < reps:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        ev[1].record()
        for _ in range(calls):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if enqueue_ms < ev[0].elapsed_time(ev[1]):
            times.append(ev[1].elapsed_time(ev[2]) / calls)
        else:
            sleep_ms *= 2
            check(sleep_ms < 1e4, "queued_ms: enqueue outruns any sleep")
    return statistics.median(times), host_ms


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


def ragged_case(C: int, B: int, R: int, N: int, per_chip_x: bool,
                per_chip_g: bool, gen, x_kind: str = "bits"):
    """Random operands of any shape: {0,1} placement planes at 20/60/20
    whose first min(32, R) rows are all ones (the bias rows), log-normal
    effective planes with the HRS leak, word lines behind all-ones bias
    rows, and the periphery noise.  The word lines are bits at density 0.5
    (`x_kind="bits"`), uniform in [0, 1) (`"real"`), or bits with one value
    of 0.37 in every 7th row at plane row R // 2 (`"mixed"`: {0,1} IR
    blocks, then one that is not)."""
    import torch
    dev = gen.device
    u = torch.rand(((C,) if per_chip_g else ()) + (R, N), generator=gen,
                   device=dev)
    gp, gn = (u > 0.8).float(), (u < 0.2).float()
    gp[..., :BIAS_ROWS, :] = 1.0
    gn[..., :BIAS_ROWS, :] = 1.0

    def eff(g):
        mask = torch.exp(0.4245 * torch.randn((C, R, N), generator=gen,
                                              device=dev))
        return (g * mask + (1.0 - g) * 1e-4).contiguous()

    lead = (C,) if per_chip_x else ()
    x = torch.rand(lead + (B, R), generator=gen, device=dev)
    if x_kind != "real":
        x = (x < 0.5).float()
    if x_kind == "mixed":
        x[..., ::7, R // 2] = 0.37
    x[..., :BIAS_ROWS] = 1.0
    eps = torch.randn((C, B, N), generator=gen, device=dev)
    rnd = (torch.rand((C, B, N), generator=gen, device=dev) < 0.5).float()
    return x, eff(gp), eff(gn), gp, gn, eps, rnd


def check_layout(tag, ops_, C, B, per_chip_x, per_chip_g, gen, shape=None,
                 x_kind="bits", tiles=(None,)):
    """Kernel vs plain version on one layout, at full width or at `shape`
    (R, N) with word lines of `x_kind` (`ragged_case`), at each of K1's row
    `tiles` (None: the default; C = 1 with both operands shared then goes
    through K2): counts exact, the diff and binary outputs bit-identical
    (the kernel adds and rounds in the plain version's float32 order).
    Returns (max |diff error|, binary flips)."""
    import torch
    from repro_torch.kernels.ref import (IrcEpilogueParams,
                                         irc_mvm_chips_ref, near_tie_flips)
    from repro_torch.core.macro import DEFAULT_MACRO
    if shape is None:
        x, ep, en, gp, gn, eps, rnd = make_case(C, B, per_chip_x,
                                                per_chip_g, gen)
    else:
        x, ep, en, gp, gn, eps, rnd = ragged_case(C, B, *shape, per_chip_x,
                                                  per_chip_g, gen, x_kind)
    single = C == 1 and not per_chip_x and not per_chip_g

    def run(params, a, b, c, d, tile):
        if single and tile is None:
            return ops_.irc_mvm(x, a[0], b[0], c, d, eps[0], rnd[0],
                                params)[None]
        return ops_.irc_mvm_chips(x, a, b, c, d, eps, rnd, params, tile=tile)

    def tagged(tile):
        return tag if tile is None else f"{tag} tile {tile}"

    off = dict(apply_nonlinearity=False, apply_ir=False, apply_sa=False,
               apply_range=False)
    # counts: with e+ := g+ (e- := 0) and every effect off, the diff output
    # is the activated-LRS count p+ (and -p- the other way), exact integers
    p_diff = IrcEpilogueParams.from_macro(DEFAULT_MACRO, output="diff", **off)
    zeros = torch.zeros_like(ep)
    gpc = gp.expand(ep.shape).contiguous()
    gnc = gn.expand(en.shape).contiguous()
    # (with other word lines the block-by-block sum differs from x @ g in
    # rounding; their counts reach the outputs checked below)
    counted = ((gpc, zeros, 1.0, gp), (zeros, gnc, -1.0, gn))
    for a, b, sign, g in counted if x_kind == "bits" else ():
        want = sign * (x @ g)
        for tile in tiles:
            got = run(p_diff, a, b, gp, gn, tile)
            check(torch.equal(got, want.expand(got.shape)),
                  f"{tagged(tile)}: counts differ")
            del got
        del want
    del gpc, gnc, zeros
    worst, flips = 0.0, 0
    for effects in ("all", "none"):
        eff = {} if effects == "all" else off
        for output in ("diff", "binary"):
            params = IrcEpilogueParams.from_macro(DEFAULT_MACRO,
                                                  output=output, **eff)
            want, margin = irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd,
                                             params, margin=True)
            for tile in tiles:
                got = run(params, ep, en, gp, gn, tile)
                if output == "diff":
                    err = float((got - want).abs().max())
                    worst = max(worst, err)
                    same = float((got == want).float().mean())
                    if shape is None:
                        log("3 kernels", f"{tagged(tile)} {effects}: diff "
                            f"bit-identical to the plain version on "
                            f"{same:.6f} of outputs")
                    check(torch.equal(got, want),
                          f"{tagged(tile)} {effects}: diff not "
                          f"bit-identical, max|err| {err}")
                else:
                    n, _ = near_tie_flips(got, want, margin)
                    check(n == 0, f"{tagged(tile)} {effects}: {n} binary "
                          f"flips")
                    flips += n
                del got
            del want, margin
    torch.cuda.synchronize()
    return worst, flips


# K1/K2 at the detector's full width: (tag, C, B, per-chip x, per-chip g)
K1_FULL_CASES = (
    ("s0b0 shared x, shared g", 4, 2 * S0_ROWS_PER_IMAGE, False, False),
    ("s0b1 per-chip x, shared g", 4, 2 * S0_ROWS_PER_IMAGE, True, False),
    ("s1 per-chip x, per-chip g", 4, 2 * S1_ROWS_PER_IMAGE, True, True),
    ("K2 single chip C=1", 1, 2 * S0_ROWS_PER_IMAGE, False, False))


def ptxas_spills(text, stack=False):
    """The `ptxas -v` lines of a build log that report spill stores or
    loads, or (unless `stack`) a stack frame."""
    import re
    bad = []
    for ln in text.splitlines():
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and (int(m[2]) or int(m[3]) or (int(m[1]) and not stack)):
            bad.append(ln.strip())
    return bad


def phase_kernels(ops_):
    """Phase 3: the kernel against its plain version at full width."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    report = {}
    for tag, C, B, pcx, pcg in K1_FULL_CASES:
        t0 = time.perf_counter()
        err, flips = check_layout(tag, ops_, C, B, pcx, pcg, gen)
        report[tag] = (err, flips)
        log("3 kernels", f"{tag}: C={C} B={B} R={R_ROWS} N={N_COLS} "
            f"counts exact, max|diff err|={err:.3g} (bit-identical), "
            f"binary flips={flips} "
            f"({time.perf_counter() - t0:.1f}s)")
        torch.cuda.empty_cache()
    return report


# K1/K2 ragged shapes across the kernel's tile edges: R gives 1, 3, 10, 18,
# 19 and 32 IR blocks (the kernel's two instantiations split at 18/19; R =
# 77 is not a multiple of 4, so x takes the 4-byte copies), B falls around
# the 32-row tile, N = 1 (odd: 4-byte plane copies), 60, 64 and 100 around
# the 32-column tile; C and the layouts rotate through {1, 3} x
# shared/per-chip x and g (C = 1 with both shared goes through K2)
K1_RAGGED_R = (32, 77, 300, 572, 600, 1000, 1024)
K1_RAGGED_N = (1, 60, 64, 100)
K1_RAGGED_B = (1, 31, 33, 1000)


def k1_ragged_cases():
    """(C, B, R, N, per-chip x, per-chip g) of the ragged checks."""
    cases = []
    for i, r in enumerate(K1_RAGGED_R):
        for j, b in enumerate(K1_RAGGED_B):
            layout = (i + 2 * j) % 4
            cases.append((3 if (i + j) % 2 else 1, b, r,
                          K1_RAGGED_N[(i + j) % 4], bool(layout & 1),
                          bool(layout & 2)))
    return cases


# word lines that are not all 0 or 1, which take the kernel's FFMA counts:
# (C, B, R, N, per-chip x, per-chip g, x kind); "mixed" switches from
# popcounts to the FFMA chain at the middle IR block
K1_NON_BINARY = ((3, 1000, 572, 60, True, True, "real"),
                 (3, 1000, 572, 60, True, False, "mixed"),
                 (1, 33, 1000, 100, False, False, "mixed"))


def phase_k1_ragged(ops_):
    """Phase 3, K1/K2 at the ragged shapes (`k1_ragged_cases`) and with
    word lines that are not all 0 or 1 (`K1_NON_BINARY`): counts exact,
    diff bit-identical, 0 binary flips.  Returns the flips."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4321)
    flips, t0 = 0, time.perf_counter()
    for C, B, R, N, pcx, pcg in k1_ragged_cases():
        tag = (f"ragged C={C} B={B} R={R} N={N} x "
               f"{'per-chip' if pcx else 'shared'}, g "
               f"{'per-chip' if pcg else 'shared'}")
        err, n = check_layout(tag, ops_, C, B, pcx, pcg, gen, shape=(R, N))
        check(err == 0.0, f"{tag}: max|diff err| {err}")
        flips += n
    log("3 kernels", f"K1/K2 at {len(k1_ragged_cases())} ragged shapes "
        f"(R in {K1_RAGGED_R}, N in {K1_RAGGED_N}, B in {K1_RAGGED_B}, C "
        f"in (1, 3), shared and per-chip x and g): counts "
        f"exact, diff bit-identical, binary flips={flips} "
        f"({time.perf_counter() - t0:.1f}s)")
    for C, B, R, N, pcx, pcg, kind in K1_NON_BINARY:
        tag = f"{kind} x C={C} B={B} R={R} N={N}"
        err, n = check_layout(tag, ops_, C, B, pcx, pcg, gen, shape=(R, N),
                              x_kind=kind)
        check(err == 0.0, f"{tag}: max|diff err| {err}")
        flips += n
        log("3 kernels", f"K1 {tag}: diff and binary outputs (all effects "
            f"on and off) bit-identical to the plain version")
    torch.cuda.empty_cache()
    return flips


# K3 shapes across the kernel's edges (plan: `kernels/ternary_matmul.py`):
# ragged B, K and N below one 128x64 tile; splits over K in clusters of 5
# and 8 blocks; f32 K with K*4 not a multiple of 16 (cp.async; its bf16 leg
# takes 2-byte loads); the layer path's 256x540x60 (bf16: cp.async);
# N > 64 and not a multiple of 8 with K split 8 ways; many row tiles per
# block (the persistent grid), also with a K range deeper than the weights
# the shared memory holds (loaded in chunks) over two column tiles
K3_CHECK_SHAPES = ((1, 16, 1), (33, 300, 77), (200, 1000, 40),
                   (65, 301, 60), (256, 540, 60), (300, 2048, 130),
                   (20000, 540, 60), (40000, 1000, 70))
# K3 timed shapes: (name, B, K, N, x kind, back-to-back calls per timing)
K3_TIMED = (("layer", 256, 540, 60, "bits", 200),
            ("kernel_bench", 256, 2048, 512, "normal", 50),
            ("s0", 2 * S0_ROWS_PER_IMAGE, 540, 60, "bits", 3))
# the split-K path's shapes, called again and again: its sum over the
# cluster is in a fixed order, so every call must give the same bits
K3_REPEAT_SHAPES = ((256, 540, 60), (256, 2048, 512))
K3_REPEATS = 300
K3_NORMAL = dict(rtol=1e-5, atol=1e-4)
K3_BF16 = dict(rtol=3e-2, atol=3e-2)


def k3_case(B, K, N, kind, gen):
    """x [B,K] ({0,1} at density 0.5, or normal; float32 or bfloat16) and
    int8 ternary weights [K,N] on the card."""
    import torch
    w = torch.randint(-1, 2, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    if kind == "bits":
        x = (torch.rand((B, K), generator=gen, device="cuda") < 0.5).float()
    else:
        x = torch.randn((B, K), generator=gen, device="cuda")
    return (x.to(torch.bfloat16) if kind == "bf16" else x), w


def k3_plan(x, N):
    """K3's launch plan for x and N columns, as one line."""
    from repro_torch.kernels import ternary_matmul as kern
    pl = kern.plan_for(x, N)
    return (f"{pl.path}, split {pl.split} x {pl.k_slice}, grid {pl.grid}, "
            f"{pl.kw} weight rows resident")


def k3_check(ops_, x, w, kind):
    """K3 against its plain version on x, w: {0,1} bit-identical, normal
    float32 within rtol 1e-5 / atol 1e-4, bfloat16 within 3e-2; non-finite
    outputs where the plain version's are, with their signs.  Returns the
    largest |error| over finite outputs."""
    import torch
    from repro_torch.kernels.ref import ternary_matmul_ref
    got = ops_.ternary_matmul(x, w)
    want = ternary_matmul_ref(x, w)
    torch.cuda.synchronize()
    tag = f"K3 {tuple(x.shape)}x{w.shape[1]} {kind} x"
    check(got.shape == want.shape and got.dtype == torch.float32, tag)
    if kind == "bits":
        check(torch.equal(got, want), f"{tag}: not bit-identical")
        return 0.0
    fin = torch.isfinite(want)
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"{tag}: NaNs differ")
    check(torch.equal(got[~fin & ~torch.isnan(want)],
                      want[~fin & ~torch.isnan(want)]),
          f"{tag}: infinities differ")
    torch.testing.assert_close(got[fin], want[fin],
                               **(K3_BF16 if kind == "bf16" else K3_NORMAL))
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def k3_specials(B, K, N, gen):
    """Normal x [B,K] with one special value in every 7th row (+-Inf, NaN,
    +-3e38, subnormals, zero; one to a row, so no sum overflows) and
    subnormals spread over the rows between."""
    import torch
    x = torch.randn((B, K), generator=gen, device="cuda")
    sub = torch.rand((B, K), generator=gen, device="cuda") < 0.05
    x = torch.where(sub, torch.full_like(x, 3e-39), x)
    specials = torch.tensor([float("inf"), -float("inf"), float("nan"),
                             3.0e38, -3.0e38, 1e-40, -1e-45, 0.0],
                            device="cuda")
    rows = torch.arange(0, B, 7, device="cuda")
    cols = torch.randint(0, K, (rows.numel(),), generator=gen, device="cuda")
    x[rows, cols] = specials[torch.arange(rows.numel(), device="cuda") % 8]
    return x


def phase_k3_checks(ops_):
    """Phase 3, K3: the ternary matmul against its plain version at every
    check shape ({0,1}, normal and bfloat16 x), at x views whose base is 4
    and 2 bytes off 16-byte alignment, and at x holding non-finite, huge
    and subnormal values; each line names the load path the plan took."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(77)
    for B, K, N in K3_CHECK_SHAPES:
        errs, paths = [], []
        for kind in ("bits", "normal", "bf16"):
            x, w = k3_case(B, K, N, kind, gen)
            paths.append(k3_plan(x, N))
            errs.append(k3_check(ops_, x, w, kind))
        log("3 kernels", f"ternary_matmul {B}x{K}x{N}: {{0,1}} x "
            f"bit-identical, max|err| normal x {errs[1]:.3g} (rtol 1e-5, "
            f"atol 1e-4), bf16 x {errs[2]:.3g} (3e-2); f32 plan: "
            f"{paths[1]}; bf16 plan: {paths[2]}")
    B, K, N = 300, 540, 60
    for dtype, off in ((torch.float32, 1), (torch.bfloat16, 1),
                       (torch.bfloat16, 2)):
        buf = torch.randn(B * K + 8, generator=gen, device="cuda").to(dtype)
        x = buf[off:off + B * K].view(B, K)
        check(x.data_ptr() % 16 != 0, "K3 misaligned case is aligned")
        w = torch.randint(-1, 2, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        kind = "bf16" if dtype == torch.bfloat16 else "normal"
        err = k3_check(ops_, x, w, kind)
        log("3 kernels", f"ternary_matmul {kind} x {x.data_ptr() % 16} "
            f"bytes off 16-byte alignment, {B}x{K}x{N}: max|err| "
            f"{err:.3g}; plan: {k3_plan(x, N)}")
    for B, K, N in K3_REPEAT_SHAPES:
        x, w = k3_case(B, K, N, "normal", gen)
        first = ops_.ternary_matmul(x, w)
        differ = torch.zeros((), dtype=torch.int64, device="cuda")
        for _ in range(K3_REPEATS):
            differ += (ops_.ternary_matmul(x, w) != first).sum()
        check(int(differ) == 0, f"K3 {B}x{K}x{N}: {int(differ)} outputs "
              f"differ over {K3_REPEATS} repeated calls")
        log("3 kernels", f"ternary_matmul {B}x{K}x{N} normal x, "
            f"{K3_REPEATS} repeated calls ({k3_plan(x, N)}): every output "
            f"bit-identical to the first")
    for B, K, N in ((300, 540, 60), (20000, 540, 130)):
        x = k3_specials(B, K, N, gen)
        w = torch.randint(-1, 2, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        err = k3_check(ops_, x, w, "normal")
        want = x @ w.float()
        log("3 kernels", f"ternary_matmul {B}x{K}x{N} with +-Inf, NaN, "
            f"+-3e38 and subnormals in x: NaN and Inf outputs as the plain "
            f"version's ({int(torch.isnan(want).sum())} NaN, "
            f"{int(torch.isinf(want).sum())} Inf), max|err| elsewhere "
            f"{err:.3g}")


def k3_bound_ms(B, K, N, x_bytes):
    """Least time for x [B,K] @ w [K,N] at f32 precision: 2*B*K*N
    operations per bf16 tensor-core pass against x, the int8 weights and
    the f32 output each moved once.  The weights are exact in bf16 and a
    product of two bf16 values is exact in f32, so bf16 x takes one pass;
    f32 x splits exactly into three bf16 parts (hi + mid + lo), three
    passes.  TF32 would round x, so it is no bound for this work.  Returns
    (ms, "bytes" | "operations")."""
    passes = 1 if x_bytes == 2 else 3
    t_ops = passes * 2 * B * K * N / PEAK_BF16_FLOPS * 1e3
    t_bytes = (x_bytes * B * K + K * N + 4 * B * N) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hgmma_count(source, function=""):
    """HGMMA (wgmma) instructions in the SASS of the library built from
    `source`, in the functions whose (mangled) name holds `function`: all
    of them by default."""
    from repro_torch.kernels import build
    return sum(op.startswith("HGMMA")
               for name, ins in sass_functions(
                   build.library_path(source)).items()
               if function in name for _, op, _, _ in ins)


def k3_path_times(x, w, calls):
    """x's two load paths side by side where the plan takes TMA: the plan,
    and the same plan with 4-byte cp.async, which serves any float32 x.
    Both write the same swizzled stages, so their outputs must be
    bit-identical.  Each is timed twice, alternating, through the binding
    on one preallocated output (device and host milliseconds a call).
    Returns {path: [(ms, host ms), ...]}, empty where the plan is not TMA."""
    import dataclasses
    import torch
    from repro_torch.kernels import ternary_matmul as kern
    N = w.shape[1]
    tma = kern.plan_for(x, N)
    if tma.path != "tma":
        return {}
    plans = {"tma": tma, "cp.async": dataclasses.replace(tma, path="cp.async")}
    outs = {k: torch.empty((x.shape[0], N), device="cuda") for k in plans}
    for k, pl in plans.items():
        kern.launch(x, w, outs[k], pl)
    check(torch.equal(outs["tma"], outs["cp.async"]),
          f"K3 {tuple(x.shape)}x{N}: TMA and cp.async outputs differ")
    times = {k: [] for k in plans}
    for _ in range(2):
        for k, pl in plans.items():
            times[k].append(queued_ms(
                lambda pl=pl, o=outs[k]: kern.launch(x, w, o, pl), reps=7,
                calls=calls))
    log("4 times", f"ternary_matmul {tuple(x.shape)}x{N} load paths, "
        f"outputs bit-identical; device ms (host enqueue ms) a call, two "
        f"rounds: " + "; ".join(
            f"{k} " + ", ".join(f"{ms:.4f} ({h:.4f})" for ms, h in v)
            for k, v in times.items()))
    return times


def phase_k3_times(ops_):
    """Phase 4, K3: kernel, plain version, torch.matmul yardstick (true f32,
    the weights cast outside the timed call) and bound at three shapes;
    device times from `queued_ms`, and each one's host enqueue per call.
    First it checks that the kernel's SASS holds wgmma (HGMMA)."""
    import torch
    from repro_torch.kernels import ternary_matmul as kern
    from repro_torch.kernels.ref import ternary_matmul_ref
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for matmuls")
    n_hgmma = hgmma_count(kern.SOURCE)
    log("4 times", f"ternary_matmul SASS: {n_hgmma} HGMMA (wgmma) "
        f"instructions")
    check(n_hgmma > 0, "the ternary matmul kernel has no HGMMA")
    gen = torch.Generator(device="cuda").manual_seed(78)
    out = {}
    for name, B, K, N, kind, calls in K3_TIMED:
        x, w = k3_case(B, K, N, kind, gen)
        wf = w.float()
        err = float((ops_.ternary_matmul(x, w)
                     - ternary_matmul_ref(x, w)).abs().max())
        ms, host = queued_ms(lambda: ops_.ternary_matmul(x, w), reps=7,
                             calls=calls)
        plain_ms, plain_host = queued_ms(lambda: ternary_matmul_ref(x, w),
                                         reps=5, calls=calls)
        lib_ms, lib_host = queued_ms(lambda: torch.matmul(x, wf), reps=5,
                                     calls=calls)
        b_ms, b_by = k3_bound_ms(B, K, N, x.element_size())
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         shape=(B, K, N))
        log("4 times", f"ternary_matmul {name} {B}x{K}x{N} ({kind} x; "
            f"{k3_plan(x, N)}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, torch.matmul f32 {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), share of bound {b_ms / ms:.3f}, max|err| {err:.3g}")
        log("4 times", f"ternary_matmul {name}: host enqueue per call: "
            f"kernel {host:.4f} ms, plain {plain_host:.4f} ms, torch.matmul "
            f"{lib_host:.4f} ms")
        out[name]["paths"] = k3_path_times(x, w, calls)
        del x, w, wf
        torch.cuda.empty_cache()
    return out


# K4: (H, Sq, Sk, hd) of tests/test_kernels.py::TestFlashAttention, a
# ragged Sq > Sk case, and one attention layer of chameleon-34b (64 query
# heads, K/V expanded to H, head_dim 128) at the train_4k length
K4_TEST_SHAPES = ((2, 64, 64, 16), (4, 128, 128, 32), (1, 100, 100, 16),
                  (2, 256, 256, 64), (2, 96, 40, 16))
K4_CHAMELEON = (64, 4096, 4096, 128)
# ragged at the bf16 kernel's TMA box edges (128 query rows, 64 keys),
# spanning several turns of its 3-stage ring, one with Sq > Sk
K4_RAGGED_SHAPES = ((4, 1000, 1000, 128), (2, 4096, 1000, 64))
K4_F32 = dict(atol=2e-5, rtol=1e-4)
K4_BF16 = dict(atol=3e-2, rtol=3e-2)


def k4_case(H, Sq, Sk, hd, dtype, gen):
    """q [H,Sq,hd], k/v [H,Sk,hd], standard normal, on the card."""
    import torch
    q, k, v = (torch.randn((H, S, hd), generator=gen, device="cuda")
               for S in (Sq, Sk, Sk))
    return tuple(t.to(dtype) for t in (q, k, v))


def bf16_row_ratio(got, q, k, v):
    """Worst ratio of the bf16 output's error to the bound it should keep:
    against the plain version in f32 on the same bf16 inputs, one bf16
    rounding of each output (2^-8 of its size) plus 1e-4 of its query row's
    largest output for the f32 sum order.  At most 1 when the kernel is
    right; scaled by row, so late rows, whose outputs average thousands of
    values and are small, are held as tightly as early ones."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    want = flash_attention_ref(q.float(), k.float(), v.float())
    row = want.abs().amax(-1, keepdim=True)
    bound = 2.0 ** -8 * want.abs() + 1e-4 * row
    return float(((got.float() - want).abs() / bound).max())


def phase_k4_checks(ops_):
    """Phase 3, K4: causal flash attention against its plain version, both
    tile sizes at the test shapes and the ragged shapes, float32 and
    bfloat16; the default tiles at chameleon-34b's shape.  bfloat16 is held
    at the JAX tests' 3e-2 and, row by row, to one bf16 rounding
    (`bf16_row_ratio`).  Returns max |err| at chameleon-34b's shape by
    dtype name."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(44)
    cases = [(shape, tiles) for shape in K4_TEST_SHAPES + K4_RAGGED_SHAPES
             for tiles in ((64, 64), (32, 32), (64, 32))]
    cases.append((K4_CHAMELEON, (64, 64)))
    err_chameleon = {}
    for (H, Sq, Sk, hd), (bq, bk) in cases:
        errs = []
        for dtype, tol in ((torch.float32, K4_F32),
                           (torch.bfloat16, K4_BF16)):
            q, k, v = k4_case(H, Sq, Sk, hd, dtype, gen)
            got = ops_.flash_attention(q, k, v, bq=bq, bk=bk)
            want = flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == (H, Sq, hd),
                  f"K4 {H}x{Sq}x{Sk}x{hd}: {got.dtype} {tuple(got.shape)}")
            torch.testing.assert_close(got.float(), want.float(), **tol)
            errs.append(float((got.float() - want.float()).abs().max()))
            del want
            if dtype == torch.bfloat16:
                ratio = bf16_row_ratio(got, q, k, v)
                check(ratio <= 1.0, f"K4 {H}x{Sq}x{Sk}x{hd} bf16: error "
                      f"{ratio:.3f} x its row-scaled bound")
            del q, k, v, got
            torch.cuda.empty_cache()
        if (H, Sq, Sk, hd) == K4_CHAMELEON:
            err_chameleon = {"float32": errs[0], "bfloat16": errs[1]}
        log("3 kernels", f"flash_attention H={H} Sq={Sq} Sk={Sk} hd={hd} "
            f"tiles {bq}x{bk}: max|err| f32 {errs[0]:.3g} (atol 2e-5, rtol "
            f"1e-4), bf16 {errs[1]:.3g} (3e-2; row-scaled {ratio:.3f} of "
            f"one bf16 rounding + 1e-4 of the row)")
    # bf16 operands that start 2 bytes past a 16-byte boundary (views into
    # one buffer): a TMA tensor map takes 16-byte starts only
    H, Sq, Sk, hd = 2, 200, 150, 64
    buf = torch.randn(H * (Sq + 2 * Sk) * hd + 3, generator=gen,
                      device="cuda").bfloat16()
    n_q, n_kv = H * Sq * hd, H * Sk * hd
    q, k, v = (buf[o:o + n].view(H, -1, hd) for o, n in (
        (1, n_q), (1 + n_q, n_kv), (1 + n_q + n_kv, n_kv)))
    check(q.data_ptr() % 16 != 0, "K4 misaligned case is aligned")
    got = ops_.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v).float(),
                               **K4_BF16)
    ratio = bf16_row_ratio(got, q, k, v)
    check(ratio <= 1.0, f"K4 misaligned bf16: error {ratio:.3f} x bound")
    log("3 kernels", f"flash_attention bf16 operands 2 bytes off 16-byte "
        f"alignment, {H}x{Sq}x{Sk}x{hd}: row-scaled {ratio:.3f}")
    # f32 operands 4 bytes past a 16-byte boundary, which the split's
    # float4 loads cannot take either
    buf = torch.randn(H * (Sq + 2 * Sk) * hd + 1, generator=gen,
                      device="cuda")
    q, k, v = (buf[o:o + n].view(H, -1, hd) for o, n in (
        (1, n_q), (1 + n_q, n_kv), (1 + n_q + n_kv, n_kv)))
    check(q.data_ptr() % 16 == 4, "K4 misaligned f32 case is aligned")
    got = ops_.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(got, want, **K4_F32)
    log("3 kernels", f"flash_attention f32 operands 4 bytes off 16-byte "
        f"alignment, {H}x{Sq}x{Sk}x{hd}: max|err| "
        f"{float((got - want).abs().max()):.3g}")
    return err_chameleon


def k4_pairs(Sq, Sk):
    """Causal (query, key) pairs: key <= query and key < Sk."""
    return sum(min(i + 1, Sk) for i in range(Sq))


def k4_passes(elem_bytes):
    """bf16 tensor-core passes the K4 kernel of the inputs' dtype runs,
    each 2*H*hd operations per causal pair: bf16 inputs take QK^T 1 + PV 3
    (p splits exactly into three bf16 parts); f32 inputs take 6 + 6
    (bf16x6: q, k, v and p each split into three parts, six of the nine
    products of parts kept per product)."""
    return 1 + 3 if elem_bytes == 2 else 6 + 6


def k4_bound_ms(H, Sq, Sk, hd, elem_bytes):
    """Least time for causal attention at the reference's f32 precision,
    as the kernel of the inputs' dtype computes it: `k4_passes` bf16
    tensor-core passes of 2*H*hd operations per causal pair, against q, k,
    v read once and the output written once, and one exp per pair on the
    special-function units (a floor under the products).  A bf16 product
    is exact in f32, so no pass rounds an operand, as TF32 would.
    Returns (ms, "bytes" | "operations")."""
    pairs = k4_pairs(Sq, Sk)
    t_mma = k4_passes(elem_bytes) * 2 * H * hd * pairs / PEAK_BF16_FLOPS
    t_ops = max(t_mma, H * pairs / PEAK_MUFU_OPS) * 1e3
    t_bytes = elem_bytes * H * hd * (2 * Sq + 2 * Sk) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k4_ffma_ms(H, Sq, Sk, hd):
    """Both products of f32 attention on the FFMA pipes (true f32
    products, as an FFMA kernel runs them): 2 x 2*H*hd operations per
    causal pair at 67 TFLOP/s, in ms."""
    return 2 * 2 * H * hd * k4_pairs(Sq, Sk) / PEAK_F32_FLOPS * 1e3


def phase_k4_times(ops_):
    """Phase 4, K4 at chameleon-34b's shape, float32 and bfloat16: kernel,
    plain version, scaled_dot_product_attention (causal; TF32 off, as the
    port keeps it) and bound; device times from `queued_ms`.  Each leg's
    rate on the bf16 passes it runs (`k4_passes`); for float32 also the
    split pre-pass alone and the bound on the FFMA pipes, for bfloat16 sdpa
    in float32 on the upcast inputs (the same precision).  First it checks
    that each leg's SASS holds wgmma (HGMMA) instructions."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import flash_attention_ref
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for matmuls")
    from repro_torch.kernels import flash_attention_cuda
    for leg in ("f32", "bf16"):
        n_hgmma = hgmma_count(flash_attention_cuda.SOURCE,
                              f"flash_attention_{leg}_kernel")
        log("4 times", f"flash_attention {leg} leg SASS: {n_hgmma} HGMMA "
            f"(wgmma) instructions")
        check(n_hgmma > 0, f"the {leg} flash-attention leg has no HGMMA")
    gen = torch.Generator(device="cuda").manual_seed(45)
    H, Sq, Sk, hd = K4_CHAMELEON
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = k4_case(H, Sq, Sk, hd, dtype, gen)
        ms, host = queued_ms(lambda: ops_.flash_attention(q, k, v), reps=5,
                             calls=3)
        plain_ms, plain_host = queued_ms(
            lambda: flash_attention_ref(q, k, v), reps=3, calls=1)
        lib_ms, lib_host = queued_ms(
            lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), reps=5, calls=3)
        b_ms, b_by = k4_bound_ms(H, Sq, Sk, hd, q.element_size())
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log("4 times", f"flash_attention {name} H={H} S={Sq} hd={hd} "
            f"causal: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa "
            f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), share of bound "
            f"{b_ms / ms:.3f}")
        log("4 times", f"flash_attention {name}: host enqueue per call: "
            f"kernel {host:.4f} ms, plain {plain_host:.4f} ms, sdpa "
            f"{lib_host:.4f} ms")
        passes = k4_passes(q.element_size())
        work = passes * 2 * H * hd * k4_pairs(Sq, Sk)
        rate = (f"flash_attention {name}: {work / ms / 1e9:.1f} TFLOP/s on "
                f"its {passes}-pass work ({work:.4g} flop), {b_ms / ms:.3f} "
                f"of its bound")
        if dtype == torch.float32:
            parts = torch.empty(flash_attention_cuda.parts_numel(H, Sk, hd),
                                dtype=torch.bfloat16, device="cuda")
            split_ms, _ = queued_ms(
                lambda: flash_attention_cuda.split(k, v, parts), reps=5,
                calls=3)
            log("4 times", f"{rate} (bf16x6: QK^T 6 + PV 6 passes); the "
                f"split of k and v alone {split_ms:.3f} ms of the call "
                f"({1e-9 * (4 + 6) * H * hd * 2 * Sk / split_ms:.2f} TB/s "
                f"on its f32 reads and bf16 writes); on the FFMA pipes the "
                f"bound would be {k4_ffma_ms(H, Sq, Sk, hd):.3f} ms")
            out[name]["split_ms"] = split_ms
            del parts
        else:
            qf, kf, vf = (t.float() for t in (q, k, v))
            f32_ms, _ = queued_ms(
                lambda: F.scaled_dot_product_attention(
                    qf[None], kf[None], vf[None], is_causal=True),
                reps=3, calls=2)
            log("4 times", f"{rate} (QK^T 1 + PV 3 passes); sdpa f32 on "
                f"the upcast inputs (same precision) {f32_ms:.3f} ms, sdpa "
                f"bf16 (P rounded to bf16) {lib_ms:.3f} ms")
            del qf, kf, vf
        del q, k, v
        torch.cuda.empty_cache()
    return out


# the elementwise kernels of XLA's float32 math (csrc/xla_math.cu) at the
# main paths' shapes: one 512-die layer chunk's variation mask (erf_inv,
# exp) and the detector's s0 SA epilogue, 4 chips x 2 images (fma)
XLA_MASK_SHAPE = (512, R_ROWS, N_COLS)
XLA_EPILOGUE_SHAPE = (4, 2 * S0_ROWS_PER_IMAGE, N_COLS)
# float32 operations per element on the cheaper branch (so the bound stays
# a lower bound): a fused multiply-add; erf_inv with log1p's small branch;
# exp
XLA_OPS = {"xla_fma": 1, "xla_erf_inv": 33, "xla_exp": 13}
# the reference's jnp code each one computes in XLA's rounding (XLA fuses
# it; there is no Pallas kernel behind it)
XLA_REPLACES = {"xla_fma": "src/repro/core/nonideal.py:139",
                "xla_erf_inv": "src/repro/core/nonideal.py:64",
                "xla_exp": "src/repro/core/nonideal.py:65"}


def xla_cases(gen):
    """{kernel: (kernel call, plain call, library call, bytes moved,
    elements)} on the main paths' shapes; the uniforms include 0 and the
    poles +-1."""
    import torch
    from repro_torch import xla_order as xo
    from repro_torch.kernels import ops
    u = torch.rand(XLA_MASK_SHAPE, generator=gen, device="cuda") * 2 - 1
    u.view(-1)[:4] = torch.tensor([0.0, 1.0, -1.0, -0.0], device="cuda")
    z = 0.6 * torch.randn(XLA_MASK_SHAPE, generator=gen, device="cuda")
    diff, eps = (torch.randn(XLA_EPILOGUE_SHAPE, generator=gen,
                             device="cuda") for _ in range(2))
    sigma = 1.0 + torch.rand(XLA_EPILOGUE_SHAPE[1:], generator=gen,
                             device="cuda")         # shared by the chips
    scale = 0.6
    n_u, n_e = u.numel(), diff.numel()
    return {
        "xla_fma": (lambda: ops.xla_fma(sigma, eps, diff),
                    lambda: xo.fma_plain(sigma, eps, diff),
                    lambda: torch.addcmul(diff, sigma, eps),
                    4 * (sigma.numel() + 3 * n_e), n_e),
        "xla_erf_inv": (lambda: ops.xla_erf_inv(u, scale),
                        lambda: xo.erf_inv_plain(u, scale),
                        lambda: torch.special.erfinv(u), 8 * n_u, n_u),
        "xla_exp": (lambda: ops.xla_exp(z), lambda: xo.exp_plain(z),
                    lambda: torch.exp(z), 8 * n_u, n_u)}


def same_bits(a, b) -> bool:
    """Equal float32 bit patterns (NaNs included)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_xla_checks(ops_):
    """Phase 3, the elementwise kernels of XLA's float32 math against their
    plain versions (float64-emulated fused multiply-adds) at the main
    paths' shapes, and the fused multiply-add on the operand layouts of
    `fma_layouts`, which reach each of its paths: bit-identical."""
    import torch
    from repro_torch import xla_order as xo
    from repro_torch.kernels import xla_math
    gen = torch.Generator(device="cuda").manual_seed(55)
    for name, (kern, plain, _, _, n) in xla_cases(gen).items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(same_bits(got, want), f"{name}: not bit-identical to its plain"
              f" version ({int((got != want).sum())} of {n} differ)")
        log("3 kernels", f"{name} {tuple(got.shape)}: bit-identical to the "
            f"plain version")
        del got, want
    paths = {}
    for args in fma_layouts(gen):
        shape = torch.broadcast_shapes(*(v.shape for v in args
                                         if torch.is_tensor(v)))
        path = xla_math.fma_geometry(shape, [
            v.expand(shape) if torch.is_tensor(v) else v for v in args])[2]
        check(same_bits(ops_.xla_fma(*args), xo.fma_plain(*args)),
              f"xla_fma {tuple(shape)} ({path} path): differs from plain")
        paths[path] = paths.get(path, 0) + 1
    check(set(paths) == set(xla_math.FMA_PATHS),
          f"xla_fma: layouts reached paths {paths}")
    log("3 kernels", f"xla_fma broadcast, strided, scalar, 0-dim and "
        f"misaligned operands on every path (cases per path: {paths}): "
        f"bit-identical")
    torch.cuda.empty_cache()


def fma_layouts(gen):
    """xla_fma operand triples that reach each of its paths: float4 (the SA
    epilogue's broadcast sigma, contiguous operands, a broadcast column),
    32-bit (odd inner axes, strided, scalar and 0-dim operands, a
    misaligned view) and 64-bit (more than 4 axes left after
    coalescing)."""
    import torch

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    a, b, c = r(4, 1, N_COLS), r(1, 4096, N_COLS), r(N_COLS, 4096, 4)
    sig, eps, diff = 1 + r(4096, N_COLS).abs(), r(4, 4096, N_COLS), \
        r(4, 4096, N_COLS)
    big = r(100_001)
    return [(a, b, c.transpose(0, 2)), (-1.5e-5, c, 1.0), (a, 2.2e-5, b),
            (torch.tensor(3.0, device="cuda"), b, a), (sig, eps, diff),
            (eps, sig, diff), (diff, eps, sig), (r(7), r(7), r(7)),
            (r(33, 5)[:, 1:], 2.0, r(33, 4)), (r(50, 8)[:, ::2], r(4), 0.5),
            (r(1), r(1), r(1)), (r(640, 3)[:, :1], r(640, 16), 0.0),
            (r(16, 640).t(), r(640, 16), r(16)),
            (big[1:], big[:-1], 1.0), (torch.tensor(2.0, device="cuda"),
                                       torch.tensor(0.5, device="cuda"),
                                       torch.tensor(-1.0, device="cuda")),
            (r(2, 3, 4, 5, 6), r(6), r(2, 1, 4, 1, 6)),
            (r(2, 3, 4, 5, 6, 7).permute(5, 4, 3, 2, 1, 0), 1.5, r(1))]


# the die-sampling kernel (csrc/threefry.cu): the first layer's periphery
# draw, 4 chips x (2 images of s0) x 60 columns, its largest, and one
# 512-die layer chunk's variation mask, the layer path's largest
THREEFRY_KEYS = 4
THREEFRY_SHAPE = (2 * S0_ROWS_PER_IMAGE, N_COLS)
THREEFRY_MASK_KEYS = 512
THREEFRY_MASK_SHAPE = (R_ROWS, N_COLS)
SIGMA_LRS = 0.4245
# The fewest instructions a bit-identical word needs, by kind: "alu" issue
# only on the ALU pipe (funnel shifts, xors, compares, selects), "adds" on
# the ALU or as IMAD on the FMA pipe, "fma" are float32 on the FMA pipe,
# "mufu" reciprocals and conversions.  A threefry block is 20 rounds of an
# add, a funnel shift and an xor, and six key injections of 2 adds each;
# an add into x0 folds into the next round's add (a three-input IADD3), and
# the partitionable scheme's x0 = 0 + k0 needs none: 27 adds and 20 + 20 + 1
# (o0 ^ o1) ALU instructions per word; the original scheme's block (x0 =
# j + k0) has 28 adds and 40 ALU instructions for its two words.
THREEFRY_BLOCK = {True: {"alu": 41, "adds": 27},
                  False: {"alu": 20, "adds": 14}}
# Per word of each tail, on its cheaper branches (log1p's rational one,
# erf_inv's lower polynomial) and without the special cases that a draw's
# inputs never reach: the float of the top 23 bits (one LEA.HI) and its
# uniform (an add and a fused multiply-add; no clamp: u never falls below
# lo); the normal's x = -u^2, log1p (Q 6, P 6, x^2 and x^3 2, a correctly
# rounded division: a reciprocal and 5 FMA-pipe steps, 3 more), erf_inv
# (9), the two scales and two compares for the branches; exp (12, a floor,
# a float-to-int conversion and a shift into the exponent); bernoulli an
# integer compare and a select.
THREEFRY_TAIL = {
    "bits": {},
    "uniform": {"alu": 1, "fma": 2},
    "normal": {"alu": 3, "fma": 36, "mufu": 1},
    "lognormal": {"alu": 4, "fma": 48, "mufu": 3},
    "bernoulli": {"alu": 2},
    # the normal's, then the cdf on its cheaper branch (|w| < sqrt(1/2):
    # w^2, erf's P 4 and Q 6 with a product, a correctly rounded division,
    # 1 + erf and the halving, a compare) and `jnp.interp` over the
    # 19-point table as a 5-step bisection (a compare and a select each;
    # the segment's constants are loads), x - x0, a division, one fused
    # multiply-add and the two end clamps
    "measured": {"alu": 18, "fma": 62, "mufu": 3}}
# the tails held on all 2^23 of their inputs (a word's top 23 bits):
# (tail, draw arguments); bernoulli also at p on and around its edges
THREEFRY_TAIL_CASES = (
    ("normal", dict(scale=1.0)), ("normal", dict(scale=SIGMA_LRS)),
    ("lognormal", dict(scale=SIGMA_LRS)),
    ("uniform", dict(minval=-0.3, maxval=2.5)),
    ("bernoulli", dict(p=0.5)), ("bernoulli", dict(p=0.3))) + tuple(
    ("bernoulli", dict(p=p)) for p in (0.0, -1.0, float("nan"), 1.0, 1.5,
                                       1 - 2**-24, 2**-23, 2**-24, 0.75))
# the kernel instantiations whose SASS phase 4 reads: (mode, original)
THREEFRY_SASS = (("normal", False), ("bernoulli", False), ("normal", True),
                 ("lognormal", False))


def threefry_words(source):
    """Counters a thread of a threefry.cu build takes per step (its
    `kWords`, 1 where it has none)."""
    import re
    m = re.search(r"constexpr int kWords = (\d+);", source.read_text())
    return int(m.group(1)) if m else 1


def threefry_layout_n(words):
    """Draw sizes across the kernel's layout of counters: n at every
    residue modulo 2 x `words` (counter pairs under the original
    scheme)."""
    return tuple(2 * words * 37 + r for r in range(2 * words))


def threefry_calls(key, shape):
    """{mode: (kernel call, plain call)} for every draw of a shape: raw
    bits, a uniform on [-0.3, 2.5), the normal, the variation mask and
    bernoulli(0.5)."""
    from repro_torch import prng
    return {
        "bits": (lambda: prng.random_bits(key, shape),
                 lambda: prng.random_bits_plain(key, shape)),
        "uniform": (lambda: prng.uniform(key, shape, -0.3, 2.5),
                    lambda: prng.uniform_plain(key, shape, -0.3, 2.5)),
        "normal": (lambda: prng.normal(key, shape),
                   lambda: prng.normal_plain(key, shape)),
        "lognormal": (lambda: prng.lognormal(key, shape, SIGMA_LRS),
                      lambda: prng.lognormal_plain(key, shape, SIGMA_LRS)),
        "bernoulli": (lambda: prng.bernoulli(key, 0.5, shape),
                      lambda: prng.bernoulli_plain(key, 0.5, shape))}


def threefry_args(mode):
    """(lo, span, factor, p) of a mode as `threefry_calls` draws it."""
    from repro_torch import prng
    lo, span = prng.tail_consts(mode, -0.3, 2.5)
    return lo, span, prng.normal_factor(
        SIGMA_LRS if mode == "lognormal" else 1.0), 0.5


def same_values(a, b) -> bool:
    """Bit-identical: float32 bit patterns, or equal integers."""
    import torch
    if a.dtype == torch.float32:
        return same_bits(a, b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def phase_threefry_checks(ops_):
    """Phase 3, the die-sampling kernel against its int64 plain version
    (`prng.*_plain`) under both threefry schemes: fold_in with broadcast
    keys and data, split into 2, 3 and 5, and every draw at the periphery
    shape [4, 294912, 60], the proposed variation mask [4, 572, 60], the
    baseline's reference-line mask [4, 636, 1], odd and single-word draws,
    one key and several (contiguous, strided and one expanded over three
    rows), n at every residue modulo twice the counters a thread takes
    (rows off 16-byte alignment): bit-identical, one launch per call; then
    every draw written 4, 8 and 12 elements past a 16-byte boundary."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import threefry as kern
    root = prng.PRNGKey(2024, device="cuda")
    ids = torch.arange(THREEFRY_KEYS, device="cuda")
    chips = prng.fold_in(root, ids)
    strided = prng.split(chips, 3)[:, 2, :]
    one = prng.fold_in(root, 7)
    expanded = one[None].expand(3, 2)
    layout_n = threefry_layout_n(threefry_words(kern.SOURCE))
    draws = ((chips, THREEFRY_SHAPE), (chips, (R_ROWS, N_COLS)),
             (chips, (636, 1)), (one, (7,)), (one, (1,)), (one, (2,)),
             (strided, (1001,)), (one, (R_ROWS, N_COLS))) + tuple(
        (k, (n,)) for n in layout_n for k in (chips, expanded))
    t0 = time.perf_counter()
    for flag in (True, False):
        with prng.threefry_partitionable(flag):
            ops_.reset_launches()
            calls = 0
            for k, d in ((one, 11), (one, ids), (chips, 21),
                         (chips[:, None, :], torch.arange(3, device="cuda")),
                         (strided, ids)):
                check(same_values(prng.fold_in(k, d),
                                  prng.fold_in_plain(k, d)),
                      f"threefry fold_in {tuple(k.shape)}: differs")
                calls += 1
            for num in (2, 3, 5):
                for k in (one, chips, strided):
                    check(same_values(prng.split(k, num),
                                      prng.split_plain(k, num)),
                          f"threefry split {num} {tuple(k.shape)}: differs")
                    calls += 1
            for k, shape in draws:
                for mode, (call, plain) in threefry_calls(k, shape).items():
                    got, want = call(), plain()
                    torch.cuda.synchronize()
                    check(same_values(got, want),
                          f"threefry {mode} keys {tuple(k.shape)} (stride "
                          f"{k.stride(0)}) shape {shape}, partitionable="
                          f"{flag}: {int((got != want).sum())} of "
                          f"{want.numel()} differ")
                    calls += 1
                    del got, want
            check(ops_.LAUNCHES["threefry"] == calls,
                  f"threefry launches {ops_.LAUNCHES['threefry']} for "
                  f"{calls} calls")
            offsets = 0
            for n in (299, 300):
                for mode, (_, plain) in threefry_calls(chips, (n,)).items():
                    want = plain()
                    for off in (1, 2, 3):
                        buf = torch.full((want.numel() + off,), -1,
                                         dtype=want.dtype, device="cuda")
                        got = buf[off:].view(want.shape)
                        code = kern.TAILS[mode][0]
                        err = kern.load().threefry_draw_launch(
                            chips.data_ptr(), chips.stride(0),
                            got.data_ptr(), THREEFRY_KEYS, n, int(not flag),
                            code, *threefry_args(mode),
                            torch.cuda.current_stream().cuda_stream)
                        torch.cuda.synchronize()
                        check(err == 0 and same_values(got, want),
                              f"threefry {mode} n={n} written "
                              f"{off * got.element_size()} bytes off "
                              f"16-byte alignment, partitionable={flag}: "
                              f"error {err} or differs")
                        offsets += 1
            scheme = "partitionable" if flag else "original"
            shapes = [tuple(k.shape[:-1]) + s for k, s in draws[:8]]
            log("3 kernels", f"threefry, {scheme} scheme: {calls} calls "
                f"(fold_in, split 2/3/5, bits, uniform, normal, log-normal "
                f"mask, bernoulli at {shapes}, n = "
                f"{layout_n[0]}..{layout_n[-1]} under 4 "
                f"keys and one key expanded over 3 rows) bit-identical to "
                f"the plain version, one launch each; {offsets} draws "
                f"written 1-3 elements past a 16-byte boundary bit-identical")
    torch.cuda.empty_cache()
    log("3 kernels", f"threefry checks: {time.perf_counter() - t0:.1f}s")


def phase_threefry_tails():
    """Phase 3, each float32 tail of the die-sampling kernel on all 2^23 of
    its inputs: words k << 9 for every k < 2^23, with low bits that the
    tails ignore, through `threefry_tail_launch` (the draw kernel's own
    tail code, whole warps at a time) in order and shuffled (so that warps
    mix lanes that take each branch), against `prng.tail_plain` on the
    card, bit for bit."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import threefry as kern
    t0 = time.perf_counter()
    k = torch.arange(1 << 23, dtype=torch.int64, device="cuda")
    words = (k << 9) | ((k * 0x9E3779B1) >> 7 & 511)
    perm = torch.randperm(1 << 23, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(57))
    for tail, kw in THREEFRY_TAIL_CASES:
        lo, span = prng.tail_consts(tail, kw.get("minval", 0.0),
                                    kw.get("maxval", 1.0))
        args = (lo, span, prng.normal_factor(kw.get("scale", 1.0)),
                kw.get("p", 0.5))
        want = prng.tail_plain(words, tail, **kw)
        for order, w, ref in (("in order", words, want),
                              ("shuffled", words[perm], want[perm])):
            got = kern.launch_tail(w, tail, *args)
            torch.cuda.synchronize()
            check(same_bits(got, ref),
                  f"threefry tail {tail} {kw} {order}: "
                  f"{int((got.view(torch.int32) != ref.view(torch.int32)).sum())}"
                  f" of 2^23 inputs differ from tail_plain")
        log("3 kernels", f"threefry tail {tail} {kw}: all 2^23 inputs, in "
            f"order and shuffled, bit-identical to tail_plain")
    del k, words, perm
    torch.cuda.empty_cache()
    log("3 kernels", f"threefry tail checks: {time.perf_counter() - t0:.1f}s")


def phase_xla_all_floats(ops_):
    """Phase 3, `xla_erf_inv` (scale 1) and `xla_exp`, whose shared code
    the die sampling calls too, on every float32 bit pattern (NaNs,
    infinities and subnormals included), in chunks of 2^26, against their
    plain versions on the card, bit for bit."""
    import torch
    from repro_torch import xla_order as xo
    t0 = time.perf_counter()
    chunk = 1 << 26
    for name, call, plain in (
            ("xla_erf_inv", lambda x: ops_.xla_erf_inv(x, 1.0),
             lambda x: xo.erf_inv_plain(x, 1.0)),
            ("xla_exp", ops_.xla_exp, xo.exp_plain)):
        bad, first = 0, []
        for lo in range(-2**31, 2**31, chunk):
            x = torch.arange(lo, lo + chunk, dtype=torch.int32,
                             device="cuda").view(torch.float32)
            got, want = call(x), plain(x)
            diff = got.view(torch.int32) != want.view(torch.int32)
            n = int(diff.sum())
            if n and len(first) < 5:
                i = diff.nonzero()[:5 - len(first), 0]
                first += [(hex(int(x.view(torch.int32)[j]) & 0xFFFFFFFF),
                           float(got[j]), float(want[j])) for j in i]
            bad += n
            del x, got, want, diff
        check(bad == 0, f"{name}: {bad} of 2^32 float32 inputs differ from "
              f"the plain version, first (input bits, kernel, plain): "
              f"{first}")
        log("3 kernels", f"{name}: all 2^32 float32 inputs bit-identical to "
            f"the plain version")
    torch.cuda.empty_cache()
    log("3 kernels", f"xla_math all-float checks: "
        f"{time.perf_counter() - t0:.1f}s")


def threefry_work(mode, partitionable):
    """The instructions one word of a draw needs, by kind: its share of a
    threefry block and its tail."""
    work = dict(THREEFRY_BLOCK[partitionable])
    for kind, count in THREEFRY_TAIL[mode].items():
        work[kind] = work.get(kind, 0) + count
    return work


def threefry_bound_ms(mode, n_keys, n, partitionable):
    """Least time for one draw of n words under each of n_keys keys: the
    largest of each pipe's time for the instructions `threefry_work`
    counts (ALU-only at 64 per SM and clock; those and the adds on the ALU
    and IMAD together, 128; float32 on the FMA pipe, 128; MUFU, 16; all of
    them through issue, 128) and of the keys read and the output written
    once at 3.35 TB/s.  Returns (ms, "bytes" | "operations", the pipe or
    "bytes")."""
    w = threefry_work(mode, partitionable)
    alu, adds, fma, mufu = (w.get(k, 0) for k in ("alu", "adds", "fma",
                                                  "mufu"))
    per_word = {"alu": alu / PIPE_RATE["alu"],
                "alu+imad": (alu + adds) / (PIPE_RATE["alu"]
                                            + PIPE_RATE["imad"]),
                "fma": fma / PIPE_RATE["fma"],
                "mufu": mufu / PIPE_RATE["mufu"],
                "issue": (alu + adds + fma + mufu) / PIPE_RATE["issue"]}
    pipe = max(per_word, key=per_word.get)
    t_ops = per_word[pipe] * n_keys * n / SM_CLOCKS_PER_S * 1e3
    out_bytes = 8 if mode == "bits" else 4
    t_bytes = (16 * n_keys + out_bytes * n_keys * n) / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", pipe
    return t_bytes, "bytes", "bytes"


# SASS opcodes (their first dotted part) by the pipe they issue on;
# anything else counts as "other".  VIADD, sm_90's 32-bit add, issues on
# the FMA pipe as IMAD does: counted on the ALU pipe, it would put the
# bernoulli draw's instructions a word above what its measured time allows
# at 64 a clock
SASS_CLASSES = {
    "alu": ("SHF", "LOP3", "IADD3", "ISETP", "FSETP", "FSEL", "SEL", "FMNMX",
            "IMNMX", "PRMT", "LEA", "MOV", "PLOP3", "IABS", "FCHK", "P2R",
            "R2P"),
    "fma": ("FFMA", "FADD", "FMUL", "IMAD", "FMUL32I", "FADD32I",
            "FFMA32I", "IMAD32I", "VIADD"),
    "mufu/cvt": ("MUFU", "I2F", "F2I", "FRND", "F2F", "I2FP", "F2IP"),
    "memory": ("LDG", "STG", "LD", "ST", "LDS", "STS", "LDC", "LDL", "STL",
               "ATOM", "RED"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "VOTE", "NOP",
                "RET", "CALL", "BAR", "YIELD", "BREAK", "JMP")}


def sass_functions(library):
    """{mangled function name: [(address, opcode, branch target or None,
    predicated)]} from `cuobjdump -sass` of a built library."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    return parse_sass(subprocess.run(
        [str(tool), "-sass", str(library)], capture_output=True, text=True,
        check=True).stdout)


def parse_sass(sass):
    """`sass_functions` of `cuobjdump -sass`'s text."""
    import re
    line_re = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);")
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
            continue
        m = line_re.match(line)
        if name is None or not m:
            continue
        op = m.group(3)
        target = None
        if op.split(".")[0] == "BRA":
            hexes = re.findall(r"0x([0-9a-f]+)", m.group(4))
            target = int(hexes[-1], 16) if hexes else None
        funcs[name].append((int(m.group(1), 16), op, target,
                            m.group(2) is not None))
    return funcs


def sass_loop(instrs):
    """The main loop: the innermost loop (the range of a conditional
    backward branch; the unconditional jumps back from out-of-line code are
    no loops) that holds a store.  Returns [(opcode, voted)], `voted` for
    the instructions that run only where a warp vote (VOTE.ANY, then a
    conditional forward branch that skips them or jumps to them over an
    unconditional jump past them) asks for them."""
    loops = [(t, a) for a, op, t, pred in instrs
             if t is not None and t <= a and pred]

    def inside(r, s):
        return s[0] <= r[0] and r[1] <= s[1] and r != s

    stores = [ins[0] for ins in instrs if ins[1].startswith("STG")]
    main = [r for r in loops if any(r[0] <= x <= r[1] for x in stores)]
    main = [r for r in main if not any(inside(s, r) for s in main)]
    if not main:
        return []
    t, a = max(main, key=lambda r: r[1] - r[0])
    body = [ins for ins in instrs if t <= ins[0] <= a]
    at = {ins[0]: i for i, ins in enumerate(body)}
    voted = set()
    for i, (_, op, _, _) in enumerate(body):
        if not op.startswith("VOTE.ANY"):
            continue
        guard = next((b for b in body[i + 1:i + 4]
                      if b[2] is not None and b[3] and b[2] > b[0]), None)
        j = at.get(guard[2]) if guard else None
        if j is None:
            continue
        if body[j - 1][1] == "BRA" and not body[j - 1][3]:
            voted.update(b[0] for b in body[j:] if b[0] < body[j - 1][2])
        else:
            voted.update(b[0] for b in body if guard[0] < b[0] < guard[2])
    return [(op, addr in voted) for addr, op, _, _ in body]


def sass_classes(ops):
    """{class: count} and {opcode head: count} of a list of opcodes."""
    heads, classes = {}, {}
    for op in ops:
        head = op.split(".")[0]
        heads[head] = heads.get(head, 0) + 1
        cls = next((c for c, names in SASS_CLASSES.items() if head in names),
                   "other")
        classes[cls] = classes.get(cls, 0) + 1
    return classes, heads


def resource_usage(library):
    """{mangled function name: (registers, stack bytes)} from `cuobjdump
    -res-usage`."""
    import re
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-res-usage", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function ([^\s:]+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
    return out


def occupancy_warps(registers, threads=256):
    """Resident warps per SM of a kernel that uses `registers` a thread in
    blocks of `threads` (registers allocated 256 a warp; 65,536 per SM; at
    most 64 warps and 32 blocks)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = min(64, 65536 // per_warp)
    return min(32, warps // (threads // 32)) * (threads // 32)


def threefry_sass(source, modes=THREEFRY_SASS):
    """Phase 4: for each instantiation in `modes` of the library
    built from `source` (a threefry.cu), its main loop's SASS per word by
    class (the loop's trip takes `kWords` counters, 1 where the source has
    none, each a word, or two under the original scheme), its registers
    and its occupancy; logs them and returns {tag: per-word classes}."""
    from repro_torch.kernels import build, threefry as kern
    per_trip = threefry_words(source)
    lib = build.library_path(source)
    funcs, usage = sass_functions(lib), resource_usage(lib)
    out = {}
    for mode, original in modes:
        key = f"draw_kernelILb{int(original)}ELi{kern.TAILS[mode][0]}E"
        name = next((n for n in funcs if key in n), None)
        res = next((v for n, v in usage.items() if key in n), None)
        check(name is not None and res is not None,
              f"threefry SASS: no function {key} in {lib}")
        words = per_trip * (2 if original else 1)
        loop = sass_loop(funcs[name])
        classes, heads = sass_classes([op for op, v in loop if not v])
        voted = sum(v for _, v in loop) / words
        regs, stack = res
        tag = f"{mode}{' original' if original else ''}"
        per_word = {c: v / words for c, v in sorted(classes.items())}
        out[tag] = dict(per_word=per_word, voted=voted, registers=regs,
                        stack=stack, warps=occupancy_warps(regs),
                        heads={h: v / words for h, v in heads.items()})
        top = sorted(heads.items(), key=lambda kv: -kv[1])[:14]
        log("4 times", f"threefry SASS {source.name} draw_kernel<"
            f"{str(original).lower()}, {mode}>: main loop "
            f"{len(loop)} instructions for {words} words; per word "
            f"{sum(per_word.values()):.2f} outside the blocks a warp vote "
            f"guards ({voted:.2f} in them): "
            + ", ".join(f"{c} {v:.2f}" for c, v in per_word.items())
            + f"; opcodes {dict(top)}; {regs} registers, {stack} bytes "
            f"stack, {occupancy_warps(regs)} of 64 warps per SM")
    return out


def threefry_timed(keys, mask_keys):
    """Phase 4's draws: (tag, mode, partitionable, keys, shape)."""
    return (("normal", "normal", True, keys, THREEFRY_SHAPE),
            ("bernoulli", "bernoulli", True, keys, THREEFRY_SHAPE),
            ("normal original", "normal", False, keys, THREEFRY_SHAPE),
            ("lognormal mask", "lognormal", True, mask_keys,
             THREEFRY_MASK_SHAPE))


def phase_threefry_times(ops_, baselines=()):
    """Phase 4, the die-sampling kernel: its SASS per word (and that of
    each build of threefry.cu in `baselines`), then the periphery draw [4,
    294912, 60] (the normal under both schemes and bernoulli(0.5)) and one
    512-die chunk's variation mask [512, 572, 60] against the int64 plain
    version, torch.randn / torch.rand with a CUDA generator (other bits;
    the one torch call of the same kind) and the bound; each baseline's
    library timed on the same draws in turns with the tree's (baseline,
    kernel, kernel, baseline), its output bit-identical to the kernel's."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import build, threefry as kern
    gen = torch.Generator(device="cuda").manual_seed(58)
    sass = {"tree": threefry_sass(kern.SOURCE)}
    libs = {}
    for src in baselines:
        sass[src.name] = threefry_sass(src)
        libs[src.name] = kern.load(src)
    root = prng.PRNGKey(5, device="cuda")
    keys = prng.fold_in(root, torch.arange(THREEFRY_KEYS, device="cuda"))
    mask_keys = prng.fold_in(root, torch.arange(THREEFRY_MASK_KEYS,
                                                device="cuda"))
    out = {}
    for tag, mode, flag, k, shape in threefry_timed(keys, mask_keys):
        n = math.prod(shape)
        full = (k.shape[0],) + shape
        with prng.threefry_partitionable(flag):
            call, plain = threefry_calls(k, shape)[mode]
            got, want = call(), plain()
            err = float((got - want).abs().max())
            del want
            base_calls = {
                name: (lambda lib=lib: kern.launch_draw(
                    k, n, not flag, mode, *threefry_args(mode), lib=lib))
                for name, lib in libs.items()}
            for name, base in base_calls.items():
                check(same_bits(base().view(got.shape), got),
                      f"threefry {tag}: {name} differs from the kernel")
            del got
            before = {name: queued_ms(b, reps=7, calls=20)[0]
                      for name, b in base_calls.items()}
            ms, host = queued_ms(call, reps=7, calls=20)
            again, _ = queued_ms(call, reps=7, calls=20)
            after = {name: queued_ms(b, reps=7, calls=20)[0]
                     for name, b in reversed(base_calls.items())}
            plain_ms = cuda_ms(plain, reps=3)
        lib = ((lambda: torch.randn(full, generator=gen, device="cuda"))
               if mode in ("normal", "lognormal") else
               (lambda: torch.rand(full, generator=gen, device="cuda")))
        lib_ms, _ = queued_ms(lib, reps=7, calls=20)
        b_ms, b_by, pipe = threefry_bound_ms(mode, k.shape[0], n, flag)
        out[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        lib_name = "randn" if mode in ("normal", "lognormal") else "rand"
        per_word = sum(sass["tree"][tag.replace(" mask", "")]["per_word"]
                       .values())
        log("4 times", f"threefry {tag} {full}: kernel {ms:.4f} ms (again "
            f"{again:.4f}), plain {plain_ms:.3f} ms, torch.{lib_name} "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {pipe}: "
            f"{threefry_work(mode, flag)} per word), share of bound "
            f"{b_ms / ms:.3f}, {per_word:.2f} SASS instructions per word in "
            f"the main loop outside the vote-guarded blocks, host enqueue "
            f"{host:.4f} ms per call")
        for name in base_calls:
            log("4 times", f"threefry {tag} {full}: baseline {name} "
                f"{before[name]:.4f} ms before the kernel, "
                f"{after[name]:.4f} ms after, share of bound "
                f"{b_ms / max(before[name], after[name]):.3f}")
        torch.cuda.empty_cache()
    return out


def phase_xla_times(ops_):
    """Phase 4, the elementwise kernels: kernel, plain version, the one
    torch call of the same function (torch.addcmul, torch.special.erfinv,
    torch.exp; not XLA's rounding) and the bound; device times from
    `queued_ms`, the plain versions' from `cuda_ms`."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(56)
    out = {}
    for name, (kern, plain, lib, nbytes, n) in xla_cases(gen).items():
        got, want = kern(), plain()
        err = float(torch.where(got.view(torch.int32) == want.view(
            torch.int32), 0.0, (got - want).abs()).max())
        del got, want
        ms, host = queued_ms(kern, reps=7, calls=20)
        # the plain versions copy their constants to the card, which
        # synchronises: CUDA events around one call, as K1's plain version
        plain_ms = cuda_ms(plain, reps=3)
        lib_ms, _ = queued_ms(lib, reps=7, calls=20)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = 2 * XLA_OPS[name] * n / PEAK_F32_FLOPS * 1e3
        b_ms, b_by = ((t_ops, "operations") if t_ops >= t_bytes
                      else (t_bytes, "bytes"))
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        log("4 times", f"{name} {n} elements: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, torch {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), share of bound {b_ms / ms:.3f}, host enqueue "
            f"{host:.4f} ms per call")
    host = xla_fma_dispatch_ms(ops_)
    log("4 times", "xla_fma host ms per small call ([4,64,16] operands, "
        "2000 calls unsynchronised, median of 5): the wrapper's direct call "
        f"on plain tensors {host['wrapper']:.5f}, the custom op "
        f"repro_torch::xla_fma (the route of fake tensors and DTensors) "
        f"{host['custom_op']:.5f}")
    out["xla_fma"]["host_ms"] = host
    torch.cuda.empty_cache()
    return out


def xla_fma_dispatch_ms(ops_, calls: int = 2000, reps: int = 5) -> dict:
    """Host milliseconds per call of one small xla_fma through the
    wrapper (`ops.xla_fma`, which calls the kernel's launcher directly on
    plain tensors) and, where the tree registers it, through the custom
    op `repro_torch::xla_fma`, taken in turns; `calls` back-to-back calls
    with no synchronisation between them, the device's share of each
    launch far below the host's.  `ops_` may be another tree's module
    (an A/B of the wrapper)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(57)
    a, b, c = (torch.randn(4, 64, 16, generator=gen, device="cuda")
               for _ in range(3))
    routes = {"wrapper": lambda: ops_.xla_fma(a, b, c)}
    if hasattr(torch.ops.repro_torch, "xla_fma"):
        routes["custom_op"] = lambda: torch.ops.repro_torch.xla_fma(
            a, b, c, 0.0, 0.0, 0.0)
    got = {k: [] for k in routes}
    for _ in range(reps):
        for k, fn in routes.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            got[k].append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in got.items()}


# the kernel every path that samples dies launches (keys, normals, masks,
# fallback bits); the plain route's epilogue and partial sums add the fused
# multiply-add.  The sampling's erf_inv and exp run inside the threefry
# kernel, so their standalone kernels launch on no path.
XLA_SAMPLING = ("threefry",)
XLA_PLAIN_ROUTE = ("threefry", "xla_fma")
XLA_OFF_PATH = ("xla_erf_inv", "xla_exp")


def check_xla_launched(tag, launches, names=XLA_SAMPLING):
    """Each of `names` ran at least once on this path, and the standalone
    erf_inv and exp kernels not at all."""
    check(all(launches[k] >= 1 for k in names)
          and all(launches[k] == 0 for k in XLA_OFF_PATH),
          f"{tag}: sampling kernels not as expected: {launches}")


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


# K1 at the macro layer's chunk: 4,096 dies, 256 shared word lines
K1_LAYER_CHUNK = (4096, 256)


def phase_times(ops_):
    """Phase 4: kernel, plain and yardstick times at the main path's
    largest shape (s0b1), at the macro layer's chunk (`K1_LAYER_CHUNK`) and,
    for K2, one chip at the s0 shape."""
    import torch
    from repro_torch.core.macro import DEFAULT_MACRO
    from repro_torch.kernels.ref import IrcEpilogueParams, irc_mvm_chips_ref
    gen = torch.Generator(device="cuda").manual_seed(99)
    params = IrcEpilogueParams.from_macro(DEFAULT_MACRO)
    params_diff = IrcEpilogueParams.from_macro(DEFAULT_MACRO, output="diff")
    out = {}
    for name, C, pcx in (("irc_mvm_chips", 4, True), ("irc_mvm", 1, False),
                         ("irc_mvm_chips layer", K1_LAYER_CHUNK[0], False)):
        B = (K1_LAYER_CHUNK[1] if C == K1_LAYER_CHUNK[0]
             else 2 * S0_ROWS_PER_IMAGE)
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


def main_detector():
    """The main path's detector: `yolo_irc.proposed()` at 576x1024, weights
    `IRCDetector.init(PRNGKey(0))`, stem BN calibrated on 8 synthetic
    images, 2 eval images; (det, params, images, eval batch, key, columns
    ideal and all)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.engine import TABLE2_ABLATION
    from repro_torch.models.detector import IRCDetector
    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides,
                                  n_classes=cfg.n_classes,
                                  n_anchors=cfg.n_anchors)
    params = det.init(prng.PRNGKey(0, device="cuda"), device="cuda")
    calib = data.batch_for_step(999, 8)
    params = det.calibrate_bn(params,
                              torch.from_numpy(calib.images).cuda())
    ev = data.batch_for_step(1000, 2)
    images = torch.from_numpy(ev.images).cuda()
    columns = tuple(c for c in TABLE2_ABLATION if c[0] in ("ideal", "all"))
    return det, params, images, ev, prng.PRNGKey(0, device="cuda"), columns


def phase_main_path(ops_):
    """Phase 5: Table II at full width through the kernel, then the
    single-chip layer path; returns the launch counts of each and the
    detector's per-chip mAPs by column."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core.crossbar import crossbar_forward
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.mc.detector_mc import run_ablation_detector
    from repro_torch.mc.engine import McConfig

    det, params, images, ev, key, columns = main_detector()
    # 3 chunks: the first steady lap enqueues the next chunk
    n_chips, chunk = 12, 4
    mc = McConfig(n_chips=n_chips, chunk_size=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_.reset_launches()
    t0 = time.perf_counter()
    results = run_ablation_detector(key, det, params, images, ev.boxes,
                                    ev.classes, ablations=columns, mc=mc,
                                    use_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops_.LAUNCHES)
    by_tile = dict(ops_.K1_LAUNCHES)
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
        f"{len(columns)} = {want}, threefry >= 1, xla_erf_inv and xla_exp "
        f"0)")
    check(launches["irc_mvm_chips"] == want
          and launches["flash_attention"] == 0, f"launches {launches}")
    log("5 main path", f"K1 launches by design and tile {by_tile}")
    check(sum(by_tile.values()) == want, f"K1 by tile {by_tile}")
    check_xla_launched("detector", launches)
    early_stop_check(det, params, images, ev, key, mc,
                     results["all"].per_chip["map50"])

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
    check_xla_launched("single-chip layer path", single_launches)
    maps = {name: res.per_chip["map50"] for name, res in results.items()}
    return launches, single_launches, maps


def early_stop_check(det, params, images, ev, key, mc, full):
    """Phase 5, the `stderr_target` stop of the detector sweep (column
    all): with the target set to the standard error after two chunks of
    the full run `full`, serial and pipelined sweeps stop at the first
    chunk boundary at or under it, the same for both (the pipelined one
    drops its in-flight chunk), with the full run's prefix as per-chip
    values."""
    import numpy as np
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.mc.detector_mc import run_mc_detector
    from repro_torch.mc.stats import StreamingMoments

    def prefix(n):
        sm = StreamingMoments()
        for lo in range(0, n, mc.chunk_size):
            sm.update(full[lo:min(lo + mc.chunk_size, n)])
        return sm.stderr()

    target = prefix(2 * mc.chunk_size)
    stop = next(n for n in range(mc.chunk_size, mc.n_chips + 1,
                                 mc.chunk_size) if prefix(n) <= target)
    mc_all = dataclasses.replace(mc, cfg=NonidealConfig.all())
    got = {}
    for pipeline in (False, True):
        res = run_mc_detector(key, det, params, images, ev.boxes, ev.classes,
                              mc=mc_all, stderr_target=target,
                              pipeline=pipeline, use_kernel=True)
        got[pipeline] = res
        check(res.n_chips == stop and np.array_equal(res.per_chip["map50"],
                                                     full[:stop]),
              f"early stop (pipeline={pipeline}): {res.n_chips} chips, "
              f"{res.per_chip['map50'].tolist()} vs the full run's "
              f"{full[:stop].tolist()}")
    log("5 main path", f"early stop, column all, stderr_target {target:.6g} "
        f"(the full run's after {2 * mc.chunk_size} chips): serial and "
        f"pipelined both stop at {stop} of {mc.n_chips} chips with the full "
        f"run's per-chip maps {full[:stop].tolist()}; wall "
        f"{got[False].wall_s:.3f} / {got[True].wall_s:.3f} s")


def phase_k4_path(ops_):
    """Phase 5, K4's path: the op entry point `ops.flash_attention` on one
    chameleon-34b attention layer, float32 then bfloat16, launch counts
    from 0; returns each call's K4 launches by dtype name."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(46)
    ops_.reset_launches()
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = k4_case(*K4_CHAMELEON, dtype, gen)
        before = ops_.LAUNCHES["flash_attention"]
        o = ops_.flash_attention(q, k, v)
        torch.cuda.synchronize()
        by_dtype[str(dtype).split(".")[-1]] = (
            ops_.LAUNCHES["flash_attention"] - before)
        check(o.dtype == dtype and o.shape == q.shape
              and bool(torch.isfinite(o).all()), f"K4 path {dtype}: bad out")
        del q, k, v, o
    launches = dict(ops_.LAUNCHES)
    log("5 k4 path", f"ops.flash_attention H=64 S=4096 hd=128, f32 and "
        f"bf16: kernel launches {launches} (want flash_attention = 2)")
    check(launches["flash_attention"] == 2
          and sum(launches.values()) == 2, f"K4 path launches {launches}")
    torch.cuda.empty_cache()
    return by_dtype


# the baseline detector at full width: chips and chunk (the plain route's
# [chips, B, 20 blocks, 60] block tensors take ~1.4 GB per chip and plane at
# s0 with 2 images)
BASELINE_CHIPS, BASELINE_CHUNK = 6, 2


def phase_baseline_detector(ops_):
    """Phase 5, the baseline design: `yolo_irc.baseline()` at 576x1024
    (binary weights against the shared reference line, in-memory BN folded
    from calibrated block statistics, partial sums of 212 rows) through
    `run_ablation_detector`, all five Table II columns; the plain route,
    so no kernel launches."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.detector_mc import run_ablation_detector
    from repro_torch.mc.engine import McConfig
    from repro_torch.models.detector import IRCDetector
    cfg = yolo_irc.baseline()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides,
                                  n_classes=cfg.n_classes,
                                  n_anchors=cfg.n_anchors)
    params = det.init(prng.PRNGKey(0, device="cuda"), device="cuda")
    params = det.calibrate_bn(
        params, torch.from_numpy(data.batch_for_step(999, 8).images).cuda())
    ev = data.batch_for_step(1000, 2)
    images = torch.from_numpy(ev.images).cuda()
    mc = McConfig(n_chips=BASELINE_CHIPS, chunk_size=BASELINE_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_.reset_launches()
    t0 = time.perf_counter()
    results = run_ablation_detector(prng.PRNGKey(0, device="cuda"), det,
                                    params, images, ev.boxes, ev.classes,
                                    mc=mc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops_.LAUNCHES)
    by_tile = dict(ops_.K1_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, res in results.items():
        m = res.metrics["map50"]
        check(np.isfinite(res.per_chip["map50"]).all()
              and res.n_chips == BASELINE_CHIPS,
              f"baseline {name}: bad population result")
        log("5 baseline", f"{name}: map50 {m['mean']:.4f}±{m['std']:.4f} "
            f"over {res.n_chips} chips, {res.chips_per_sec:.4f} chips/s "
            f"steady, {res.n_chips / res.wall_s:.4f} chips/s overall, "
            f"wall_s {res.wall_s:.3f}, first chunk {res.compile_s:.3f}s, "
            f"enqueue_s {res.enqueue_s:.3f}, device_s {res.device_s:.3f}, "
            f"host_s {res.host_s:.3f}")
    log("5 baseline", f"yolo_irc.baseline() 576x1024, 2 images, "
        f"{BASELINE_CHIPS} chips in chunks of {BASELINE_CHUNK}, "
        f"{len(results)} columns: wall {wall:.2f}s, peak device memory "
        f"{peak:.2f} GiB, kernel launches {launches} (want irc_mvm_chips 0:"
        f" partial sums take the plain route; threefry and xla_fma >= 1)")
    check(all(launches[k] == 0 for k in ("irc_mvm_chips", "irc_mvm",
                                          "ternary_matmul",
                                          "flash_attention")),
          f"baseline launches {launches}")
    check_xla_launched("baseline", launches, XLA_PLAIN_ROUTE)
    del params, images
    torch.cuda.empty_cache()
    return launches


# the layer path's two designs: (name, layer args, McConfig fields)
LAYER_DESIGNS = (
    ("proposed", dict(scheme="ternary", bias_rows=32), dict(backend="kernel")),
    ("baseline", dict(scheme="binary", bias_rows=0),
     dict(backend="plain", accumulation="partial_sum", partial_rows=256)))
LAYER_CHIPS, LAYER_CHUNK = 2048, 512


def layer_args(**kw):
    """The CLI's layer arguments at their defaults (540x60, batch 256,
    density 0.5, seed 0), with overrides."""
    import argparse
    base = dict(seed=0, fan_in=540, n_out=60, batch=256, density=0.5,
                scheme="ternary", bias_rows=32)
    base.update(kw)
    return argparse.Namespace(**base)


def phase_layer_path(ops_):
    """Phase 5, layer path: Table II in bit-agreement units for both
    designs at the CLI's full width, each run's launches counted from 0;
    returns the launch counts per design."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.launch.mc import build_layer
    from repro_torch.mc.engine import McConfig, TABLE2_ABLATION, run_ablation
    key = prng.PRNGKey(0, device="cuda")
    n_chunks = -(-LAYER_CHIPS // LAYER_CHUNK)
    counts = {}
    for design, layer_kw, mc_kw in LAYER_DESIGNS:
        args = layer_args(**layer_kw)
        mc = McConfig(n_chips=LAYER_CHIPS, chunk_size=LAYER_CHUNK, **mc_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_.reset_launches()
        t0 = time.perf_counter()
        mapped, x, ref_bits = build_layer(args, "cuda")
        results = run_ablation(key, mapped, x, ref_bits=ref_bits, mc=mc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops_.LAUNCHES)
        counts[design] = launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, res in results.items():
            agree = res.per_chip["bit_agreement"]
            m = res.metrics["bit_agreement"]
            check(res.n_chips == LAYER_CHIPS and np.isfinite(agree).all()
                  and agree.min() >= 0 and agree.max() <= 1,
                  f"layer {design} {name}: bad population result")
            log("5 layer path", f"{design} {name}: agreement "
                f"{m['mean']:.4f}±{m['std']:.4f} over {res.n_chips} chips, "
                f"{res.chips_per_sec:.1f} chips/s steady, "
                f"{res.n_chips / res.wall_s:.1f} chips/s overall, wall_s "
                f"{res.wall_s:.3f}, first chunk {res.compile_s:.3f}s, "
                f"enqueue_s {res.enqueue_s:.3f}, device_s "
                f"{res.device_s:.3f}, host_s {res.host_s:.3f}")
        ideal = results["ideal"].metrics["bit_agreement"]["mean"]
        worst = results["all"].metrics["bit_agreement"]["mean"]
        check(ideal > worst, f"layer {design}: ideal {ideal} <= all {worst}")
        want_k1 = n_chunks * len(TABLE2_ABLATION) if mc.backend == "kernel" \
            else 0
        log("5 layer path", f"{design}: {args.scheme} {args.fan_in}x"
            f"{args.n_out}, batch {args.batch}, {LAYER_CHIPS} chips in "
            f"chunks of {LAYER_CHUNK}, backend {mc.backend}, accumulation "
            f"{mc.accumulation}: wall {wall:.2f}s, peak device memory "
            f"{peak:.2f} GiB, kernel launches {launches} (want "
            f"irc_mvm_chips = {want_k1}, ternary_matmul >= 1)")
        check(launches["ternary_matmul"] >= 1
              and launches["irc_mvm_chips"] == want_k1
              and launches["flash_attention"] == 0,
              f"layer {design}: launches {launches}")
        check_xla_launched(f"layer {design}", launches,
                           XLA_PLAIN_ROUTE if mc.backend == "plain"
                           else XLA_SAMPLING)
        del mapped, x, ref_bits, results
        torch.cuda.empty_cache()
    return counts


def chunk_margin(ens, x, cfg):
    """Decision margin of every output of the kernel's plain version on
    this ensemble (what `near_tie_flips` reads)."""
    from repro_torch.core.macro import DEFAULT_MACRO
    from repro_torch.core.mapping import extend_rows
    from repro_torch.kernels.ref import IrcEpilogueParams, irc_mvm_chips_ref
    from repro_torch.mc.engine import periphery_noise
    x_ext = extend_rows(x, ens.lead_rows)
    eps, rnd = periphery_noise(ens.sa_keys, x_ext.shape[-2], ens.n_out)
    params = IrcEpilogueParams.from_macro(
        DEFAULT_MACRO, apply_nonlinearity=cfg.nonlinearity,
        apply_ir=cfg.ir_drop, apply_sa=cfg.sa_variation,
        apply_range=cfg.sensing_range)
    return irc_mvm_chips_ref(x_ext, ens.ep, ens.en, ens.gp, ens.gn, eps, rnd,
                             params, margin=True)[1]


def phase_layer_network(ops_):
    """Phase 6, layer path: one 512-die chunk through the kernel route and
    the plain batched route, for the proposed design, its bias-calibrated
    dies (per-chip placement planes) and the binary single-shot layer (a
    reference line of count operand 0.5); per-chip bit agreement of the two
    routes may differ only by near-tie decisions."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.kernels.ref import NEAR_TIE_TOL, near_tie_flips
    from repro_torch.launch.mc import build_layer
    from repro_torch.mc.engine import (bit_agreement_metric, ensemble_apply,
                                       ensemble_apply_kernel)
    from repro_torch.mc.ensemble import (calibrate_ensemble_bias,
                                         sample_ensemble)
    cfg = NonidealConfig.all()
    key = prng.PRNGKey(1, device="cuda")
    for case in ("proposed", "calibrated", "binary single-shot"):
        scheme = "binary" if case.startswith("binary") else "ternary"
        mapped, x, ref = build_layer(
            layer_args(scheme=scheme, bias_rows=0 if scheme == "binary"
                       else 32), "cuda")
        ens = sample_ensemble(key, mapped, LAYER_CHUNK, cfg=cfg)
        if case == "calibrated":
            ens = calibrate_ensemble_bias(ens, x)
            check(ens.planes_per_chip(), "calibrated planes are not per chip")
        out_k = ensemble_apply_kernel(ens, x, cfg=cfg)
        out_p = ensemble_apply(ens, x, cfg=cfg)
        margin = chunk_margin(ens, x, cfg)
        n, ok = near_tie_flips(out_k, out_p, margin)
        metric = bit_agreement_metric(ref)
        gap = (metric(out_k) - metric(out_p)).abs().cpu().numpy()
        extra = ""
        if case == "calibrated":
            units, freq = np.unique(ens.bias_units.cpu().numpy(),
                                    return_counts=True)
            extra = f", bias units {dict(zip(units.tolist(), freq.tolist()))}"
        log("6 layer network", f"{case}: {LAYER_CHUNK} dies, kernel vs "
            f"plain route: {n} near-tie flips (margin < {NEAR_TIE_TOL}), "
            f"per-chip bit agreement apart by at most {gap.max():.6f} "
            f"({int(round(gap.max() * out_k[0].numel()))} outputs){extra}")
        check(ok, f"layer {case}: {n} flips, not all near-ties")
        del ens, out_k, out_p, margin
        torch.cuda.empty_cache()


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
    params = det.init(prng.PRNGKey(1, device="cuda"), device="cuda")
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
            use_kernel=True, kernel_impl=impl).cpu().numpy()
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


# the detector service at full width: chips per request, requests per wave
# at most, requests in the scheduler's run
SERVE_COMMITTEE, SERVE_SLOTS, SERVE_REQUESTS = 4, 2, 6
K1_PER_LANE = 14        # one K1 launch per group conv of the proposed design


def phase_serve(ops_):
    """Phase `serve`: `DetectorServeEngine` on `yolo_irc.proposed()` at
    576x1024, random weights from `IRCDetector.init(PRNGKey(0))`, stem BN
    calibrated on 2 synthetic images, committee 4, 2 slots.  Six requests
    through the background scheduler (start, submit, result, stop) with
    launch counts from 0: K1 14 a request (14 a live lane of each wave),
    threefry at least once.  Then three requests served in this thread,
    wave by wave, with K1's count per wave; one committee bit-identical
    to `_sample_and_forward` at fold_in(root, rid), chips 0-3, batch 1,
    and within the near-tie bar of the same committee through K1's plain
    version (`kernel_impl="ref"`).  Returns the scheduler run's launches
    and readings."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.detector_mc import (_sample_and_forward,
                                            detector_planes)
    from repro_torch.models.detector import IRCDetector
    from repro_torch.serve import DetectorServeEngine

    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    params = det.init(prng.PRNGKey(0, device="cuda"), device="cuda")
    data = SyntheticDetectionData(cfg.img_hw, cfg.n_classes, cfg.n_anchors,
                                  cfg.strides, seed=1)
    images = data.batch_for_step(0, 2).images
    params = det.calibrate_bn(params, torch.from_numpy(images).cuda())

    def engine(**kw):
        return DetectorServeEngine(det, params, committee=SERVE_COMMITTEE,
                                   batch_slots=SERVE_SLOTS, seed=0,
                                   use_kernel=True, **kw)

    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops_.reset_launches()
    eng.start()
    try:
        t0 = time.perf_counter()
        rids = [eng.submit(images[i % 2]) for i in range(SERVE_REQUESTS)]
        responses = [eng.result(rid, timeout=300) for rid in rids]
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    launches = dict(ops_.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = eng.stats()
    waves = st["wave"]["laps"]
    lat = st["queue_latency"]
    for r in responses:
        c = r.confidence
        check(all(np.isfinite(v) for v in c.values()) and c["count"] ==
              SERVE_COMMITTEE, f"request {r.request_id}: confidence {c}")
    per_wave = {k: st[k]["total_s"] / max(st[k]["laps"], 1)
                for k in ("wave", "enqueue", "device", "host")}
    want = K1_PER_LANE * SERVE_REQUESTS
    log("5 serve", f"yolo_irc.proposed() 576x1024, committee "
        f"{SERVE_COMMITTEE}, {SERVE_SLOTS} slots, {SERVE_REQUESTS} requests "
        f"in {waves} waves (sizes "
        f"{[sum(r.wave == w for r in responses) for w in range(1, waves + 1)]}"
        f"): {SERVE_REQUESTS / wall:.4f} req/s overall, "
        f"{st['wave']['requests_per_sec']:.4f} req/s steady, wall "
        f"{wall:.3f} s, first wave {st['wave']['compile_s']:.3f} s; per wave "
        f"wall {per_wave['wave']:.4f} s, enqueue {per_wave['enqueue']:.4f} "
        f"s, device {per_wave['device']:.4f} s, host "
        f"{per_wave['host']:.4f} s; queue p50 {lat['p50']:.4f} s, p95 "
        f"{lat['p95']:.4f} s; peak device memory {peak:.2f} GiB; "
        f"{gpu_name_and_limit()}")
    log("5 serve", f"kernel launches {launches} (want irc_mvm_chips = "
        f"{K1_PER_LANE} x {SERVE_REQUESTS} live lanes = {want}, threefry "
        f">= 1)")
    check(launches["irc_mvm_chips"] == want and launches["threefry"] >= 1,
          f"serve launches {launches}")
    check_xla_launched("serve", launches)

    # wave by wave in this thread: a full wave, then a short one
    eng = engine(keep_committee=True)
    by_wave = []
    for n in (SERVE_SLOTS, 1):
        ops_.reset_launches()
        for i in range(n):
            eng.submit(images[i % 2])
        check(eng.process_pending() == n, "process_pending")
        torch.cuda.synchronize()
        by_wave.append(ops_.LAUNCHES["irc_mvm_chips"])
    log("5 serve", f"K1 launches by wave of {SERVE_SLOTS} and 1 live "
        f"lanes: {by_wave}")
    check(by_wave == [K1_PER_LANE * SERVE_SLOTS, K1_PER_LANE],
          f"K1 per wave {by_wave}")
    rid = SERVE_SLOTS                  # the short wave's request
    got = eng.result(rid, timeout=300).committee
    planes, meta = detector_planes(det, params)
    key = prng.fold_in(prng.PRNGKey(0, device="cuda"), rid)
    ids = torch.arange(SERVE_COMMITTEE, device="cuda")
    img = torch.from_numpy(images[rid % 2][None]).cuda()

    def lane(impl):
        return _sample_and_forward(
            params, img, key, ids, planes, det_cfg=cfg, spec=det.spec,
            cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta,
            use_kernel=True, kernel_impl=impl)[:, 0]

    outs = {impl: lane(impl).cpu().numpy() for impl in ("kernel", "ref")}
    same = bool(np.array_equal(got, outs["kernel"]))
    frac = float(np.mean(np.abs(got - outs["ref"]) <= 1e-4))
    lane_ms = cuda_ms(lambda: lane("kernel"), reps=3)
    log("5 serve", f"request {rid}'s committee {got.shape}: bit-identical "
        f"to _sample_and_forward at fold_in(root, {rid}) {same}; through "
        f"K1's plain version {frac:.6f} within 1e-4 (>= 0.99), "
        f"{float(np.mean(got == outs['ref'])):.6f} bit-identical")
    busy = SERVE_SLOTS * lane_ms / 1e3 / per_wave["wave"]
    log("5 serve", f"one lane's device span (CUDA events, median of 3): "
        f"{lane_ms:.3f} ms; a full wave's {SERVE_SLOTS} lanes are "
        f"{busy:.4f} of the scheduler run's mean wave wall (device idle "
        f"{1 - busy:.4f})")
    check(same and frac >= 0.99, f"serve committee: identical {same}, "
          f"near-tie agreement {frac}")
    torch.cuda.empty_cache()
    return {"launches": launches, "req_s": SERVE_REQUESTS / wall,
            "steady_req_s": st["wave"]["requests_per_sec"],
            "per_wave": per_wave, "p50": lat["p50"], "p95": lat["p95"],
            "peak_gib": peak, "lane_ms": lane_ms}


# the QAT path at full width: timed steps per configuration (after one
# warm-up step), the chips of the ensemble-aware step, and the card-vs-CPU
# bars of one single-draw step's loss and gradients
TRAIN_STEPS = 3
TRAIN_CHIPS = 2
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _named_leaves(tree, path=""):
    """(path, leaf) of a nested dict, sorted keys, depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def phase_train(ops_):
    """Phase 5, the QAT path of `yolo_irc.proposed()` at 576x1024, 2
    images, random weights from PRNGKey(0): K1 on the ensemble step's
    deviation planes (signed ep/en, every effect off, output="diff", per-chip
    word lines from s0b0's train-ensemble output) bit-identical to its plain
    version; one single-draw step with every effect on, its loss and each
    gradient leaf on the card against the same step on the CPU (relative L2
    error per leaf <= TRAIN_GRAD_RTOL, loss within TRAIN_LOSS_RTOL: the
    convolutions and BN statistics sum in other orders, and a near-tie
    activation may flip); then the single-draw step (no effects, all
    effects) and the TRAIN_CHIPS-chip ensemble step timed over TRAIN_STEPS
    steps each, with launches per step and peak memory; last, `quick_qat`
    with train_chips=TRAIN_CHIPS for TRAIN_STEPS steps, the launch counts
    of the path from 0.  Returns {"k1": K1's deviation-plane check, "grad":
    the card-vs-CPU errors, "steps": per configuration, "launches": the
    quick_qat run's}."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.core.ternary import binary_activation
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.mc.detector_mc import build_train_ensemble
    from repro_torch.mc.engine import ensemble_apply_kernel
    from repro_torch.models.detector import (IRCDetector, _batch_norm,
                                             _stem_conv)
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train.det_qat import batch_tensors, quick_qat
    from repro_torch.train.steps import (ensemble_key_for_step,
                                         make_det_qat_grad,
                                         make_det_qat_step)
    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides,
                                  n_classes=cfg.n_classes,
                                  n_anchors=cfg.n_anchors)
    dev = torch.device("cuda")
    params = det.init(prng.PRNGKey(0, device=dev), device=dev)
    images, targets = batch_tensors(data.batch_for_step(0, 2), dev)
    root = prng.PRNGKey(1, device=dev)
    key, ens_key = prng.fold_in(root, 0), ensemble_key_for_step(root, 0)
    noise, none = NonidealConfig.all(), NonidealConfig.none()
    out = {}

    # K1 on deviation planes, at s0b1's shapes
    with torch.no_grad():
        ens = build_train_ensemble(ens_key, det, params, TRAIN_CHIPS,
                                   cfg=noise)
        bn = params["stem_bn"]
        x0 = binary_activation(_batch_norm(
            _stem_conv(images, params["stem"]), bn["gamma"], bn["beta"]))
        x1 = det._gconv_train_ensemble(
            params["s0b0"], ens.layers["s0b0"], x0, 60, 60,
            key=prng.fold_in(key, 0), cfg_ni=noise)
        x_bits = det._im2col_groups(x1, 60, 1)[..., 0, :].reshape(
            TRAIN_CHIPS, -1, 540)
        del x0, x1
        g = ens.layers["s0b1"][0]
        got = ensemble_apply_kernel(g, x_bits, cfg=none, output="diff",
                                    per_chip_x=True)
        want = ensemble_apply_kernel(g, x_bits, cfg=none, output="diff",
                                     per_chip_x=True, impl="ref")
        err = float((got - want).abs().max())
        signed = bool((g.ep < 0).any() and (g.ep > 0).any()
                      and (g.en < 0).any())
        log("5 train", f"K1 on s0b1's deviation planes: C={TRAIN_CHIPS} "
            f"B={x_bits.shape[1]} R={g.rows} N={g.n_out}, per-chip word "
            f"lines (density {float(x_bits.mean()):.4f}), signed ep/en "
            f"{signed}, effects off, diff: bit-identical "
            f"{torch.equal(got, want)}, max |err| {err}, |diff| up to "
            f"{float(want.abs().max()):.4f}")
        check(torch.equal(got, want) and signed,
              "K1 on deviation planes differs from its plain version")
        out["k1"] = dict(max_abs_err=err)
        del ens, x_bits, got, want, g
    torch.cuda.empty_cache()

    # one single-draw step, every effect on: the card against the CPU
    grad_fn = make_det_qat_grad(det, cfg_ni=noise)
    loss_d, g_d = grad_fn(params, images, targets, key, ens_key)
    t0 = time.perf_counter()
    loss_h, g_h = grad_fn(_tree_cpu(params), images.cpu(),
                          _tree_cpu(targets), key.cpu(), ens_key.cpu())
    cpu_s = time.perf_counter() - t0
    errs = {}
    for (name, a), (_, b) in zip(_named_leaves(g_d), _named_leaves(g_h)):
        if name.endswith(("/mean", "/var")):     # no gradient: zeros
            continue
        a, b = a.cpu().double(), b.double()
        errs[name] = float((a - b).norm() / b.norm().clamp(min=1e-30))
    loss_err = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
    log("5 train", f"single-draw step, all effects, card vs CPU ({cpu_s:.1f}"
        f"s on the CPU): loss {float(loss_d):.6f} vs {float(loss_h):.6f} "
        f"(rel {loss_err:.2e}, <= {TRAIN_LOSS_RTOL}); gradient rel L2 "
        f"error per leaf (<= {TRAIN_GRAD_RTOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(loss_err <= TRAIN_LOSS_RTOL
          and max(errs.values()) <= TRAIN_GRAD_RTOL,
          f"QAT step: card and CPU disagree: loss {loss_err}, grads {errs}")
    out["grad"] = dict(loss_rel=loss_err, grad_rel=max(errs.values()))
    del g_d, g_h, grad_fn
    torch.cuda.empty_cache()

    # step times, launches and peak memory
    lr = torch.tensor(3e-3, dtype=torch.float32, device=dev)
    out["steps"] = {}
    for tag, chips, c in (("single-draw, no effects", 1, None),
                          ("single-draw, all effects", 1, noise),
                          (f"ensemble {TRAIN_CHIPS} chips, all effects",
                           TRAIN_CHIPS, noise)):
        step = make_det_qat_step(det, train_chips=chips, cfg_ni=c)
        p, opt, loss = step(params, adamw_init(params), images, targets, lr,
                            key, ens_key)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_.reset_launches()
        t0 = time.perf_counter()
        for s in range(1, TRAIN_STEPS + 1):
            p, opt, loss = step(p, opt, images, targets, lr,
                                prng.fold_in(root, s),
                                ensemble_key_for_step(root, s))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        per_step = {k: v / TRAIN_STEPS for k, v in ops_.LAUNCHES.items()
                    if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ok = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(p))
        log("5 train", f"{tag}: {ms:.2f} ms per step over {TRAIN_STEPS} "
            f"steps (host clock to a synchronize), loss {float(loss):.5f}, "
            f"launches per step {per_step}, peak device memory "
            f"{peak:.2f} GiB")
        check(ok, f"{tag}: non-finite loss or params")
        out["steps"][tag] = dict(ms=ms, launches=per_step, peak_gib=peak)
        del p, opt, step
        torch.cuda.empty_cache()

    # the entry point a user calls, counts from 0
    ops_.reset_launches()
    trained = quick_qat(det, data, TRAIN_STEPS, 2, train_chips=TRAIN_CHIPS,
                        cfg_ni=noise, device=dev)
    torch.cuda.synchronize()
    launches = dict(ops_.LAUNCHES)
    want = 14 * TRAIN_STEPS
    log("5 train", f"quick_qat(train_chips={TRAIN_CHIPS}, all effects, "
        f"{TRAIN_STEPS} steps, 2 images): kernel launches {launches} (want "
        f"irc_mvm_chips = 14 groups x {TRAIN_STEPS} = {want}, threefry and "
        f"xla_fma >= 1)")
    check(launches["irc_mvm_chips"] == want and launches["threefry"] >= 1
          and launches["xla_fma"] >= 1
          and all(bool(torch.isfinite(t).all())
                  for t in tree_leaves(trained)),
          f"quick_qat launches {launches}")
    out["launches"] = launches
    del trained, params
    torch.cuda.empty_cache()
    return out


def profile_breakdown(tag, fn):
    """One `fn()` (a chunk) on the card: its span on CUDA events, its host
    enqueue, and torch.profiler's device time and launches by kernel name,
    the threefry kernel's split into its draw launches and its pairs
    (fold_in, split) launches, beside the int64 elementwise ops that the
    plain sampling ran as."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(fn, reps=3)
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    log("9 profile", f"{tag}: {ms:.2f} ms device span (CUDA events, median "
        f"of 3), host enqueue {enqueue_s * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
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
        log("9 profile", f"{tag}: the profiler saw no device time: "
            f"breakdown not measured")
        return

    def part(pred):
        picked = [e for e in rows if pred(e.key)]
        return sum(dev_us(e) for e in picked), sum(e.count for e in picked)

    irc, irc_n = part(lambda k: "irc_mvm_chips_kernel" in k)
    draws, draws_n = part(lambda k: "draw_kernel" in k)
    pairs, pairs_n = part(lambda k: "pairs_kernel" in k)
    # int64 elementwise ops: what the sampling ran as before the threefry
    # kernel (554.40 ms of a detector chunk); what is left names
    # what still runs as int64 ops
    i64, i64_n = part(lambda k: "<long" in k)
    tf = draws + pairs
    log("9 profile", f"{tag}: device kernels {total / 1e3:.3f} ms in "
        f"{sum(e.count for e in rows)} launches: irc_mvm_chips "
        f"{irc / 1e3:.3f} ms ({100 * irc / total:.1f}%, {irc_n} launches), "
        f"threefry kernel {tf / 1e3:.3f} ms ({100 * tf / total:.1f}%): "
        f"draws {draws / 1e3:.3f} ms in {draws_n} launches, pairs "
        f"{pairs / 1e3:.3f} ms in {pairs_n}; int64 elementwise "
        f"{i64 / 1e3:.3f} ms ({100 * i64 / total:.1f}%) in {i64_n} "
        f"launches, rest {(total - irc - tf - i64) / 1e3:.3f} ms")
    for e in rows[:12]:
        log("9 profile", f"{tag}: {dev_us(e) / 1e3:9.3f} ms "
            f"{100 * dev_us(e) / total:5.1f}%  x{e.count:<5d} {e.key[:90]}")


def phase_profile():
    """`--only profile`: where the device time of one chunk of each main
    path goes: the full-width detector chunk (4 chips x 2 images, all
    effects) and one 512-die proposed layer chunk (540x60, all effects,
    through K1), each broken down by `profile_breakdown`."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import yolo_irc
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.detection import SyntheticDetectionData
    from repro_torch.launch.mc import build_layer
    from repro_torch.mc.detector_mc import (_sample_and_forward,
                                            detector_planes)
    from repro_torch.mc.engine import ensemble_apply_kernel
    from repro_torch.mc.ensemble import sample_ensemble
    from repro_torch.models.detector import IRCDetector
    cfg = yolo_irc.proposed()
    det = IRCDetector(cfg)
    data = SyntheticDetectionData(img_hw=cfg.img_hw, stride=cfg.strides)
    params = det.init(prng.PRNGKey(0, device="cuda"), device="cuda")
    params = det.calibrate_bn(
        params, torch.from_numpy(data.batch_for_step(999, 8).images).cuda())
    images = torch.from_numpy(data.batch_for_step(1000, 2).images).cuda()
    planes, meta = detector_planes(det, params)
    key = prng.PRNGKey(0, device="cuda")
    ids = torch.arange(4, device="cuda")

    def detector_chunk():
        return _sample_and_forward(
            params, images, key, ids, planes, det_cfg=cfg, spec=det.spec,
            cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta,
            use_kernel=True)

    profile_breakdown("detector chunk (4 chips x 2 images, all effects)",
                      detector_chunk)
    del params, planes, meta, images
    torch.cuda.empty_cache()
    mapped, x, _ = build_layer(layer_args(), "cuda")
    cfg_ni = NonidealConfig.all()

    def layer_chunk():
        ens = sample_ensemble(key, mapped, LAYER_CHUNK, cfg=cfg_ni)
        return ensemble_apply_kernel(ens, x, cfg=cfg_ni)

    profile_breakdown(f"layer chunk ({LAYER_CHUNK} dies, 540x60, all "
                      f"effects, K1)", layer_chunk)
    del x, mapped
    torch.cuda.empty_cache()
    qat_profile(det, data)


def qat_profile(det, data):
    """`--only profile`, the QAT path: one single-draw step and one
    TRAIN_CHIPS-chip ensemble step (all effects, 2 images, full width),
    each broken down by `profile_breakdown`."""
    import torch
    from repro_torch import prng
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.det_qat import batch_tensors
    from repro_torch.train.steps import (ensemble_key_for_step,
                                         make_det_qat_step)
    dev = torch.device("cuda")
    params = det.init(prng.PRNGKey(0, device=dev), device=dev)
    opt = adamw_init(params)
    images, targets = batch_tensors(data.batch_for_step(0, 2), dev)
    lr = torch.tensor(3e-3, dtype=torch.float32, device=dev)
    root = prng.PRNGKey(1, device=dev)
    key, ens_key = prng.fold_in(root, 0), ensemble_key_for_step(root, 0)
    for chips in (1, TRAIN_CHIPS):
        step = make_det_qat_step(det, train_chips=chips,
                                 cfg_ni=NonidealConfig.all())
        profile_breakdown(
            f"QAT step, train_chips={chips} (2 images, all effects)",
            lambda: step(params, opt, images, targets, lr, key, ens_key))
        torch.cuda.empty_cache()


# phase `autotune`: K1's row tiles, the autotuner's sweep and the
# detector's auto routing.  Problems: one sweep chunk (4 chips x 2 images)
# and the service's lanes (a committee of 4 on 1 image) of the proposed
# design; the per-chip mAP bar between routes (the detector parity tests')
AUTOTUNE_CHIPS, AUTOTUNE_BATCH, AUTOTUNE_WAVE_BATCH = 4, 2, 1
MAP_NEAR_TIE = 0.02


def tuning_prefix(card_name):
    """The tuning table's key prefix of a card: "cuda/<slug>/"."""
    from repro_torch.kernels.autotune import card_slug
    return f"cuda/{card_slug(card_name)}/"


def autotune_verdicts(measured, committed):
    """Each measured record (table key -> record) against the committed
    table: [(key, (bm, tm, use_kernel) measured, the committed triple or
    None, verdict)], the verdict "agrees" (same route and tile), "same
    route" (the tile differs), "differs" (the route differs) or "absent"
    (no committed entry)."""
    out = []
    for key in sorted(measured):
        m = measured[key]
        got = (int(m["bm"]), int(m["tm"]), bool(m["use_kernel"]))
        c = committed.get(key)
        if c is None:
            out.append((key, got, None, "absent"))
            continue
        want = (int(c["bm"]), int(c["tm"]), bool(c["use_kernel"]))
        verdict = ("agrees" if got == want
                   else "same route" if got[2] == want[2] else "differs")
        out.append((key, got, want, verdict))
    return out


def autotune_tiles(ops_):
    """Phase `autotune` (a): every candidate tile of K1 bit-identical to
    its plain version at the full-width shapes of phase 3 (K2's C = 1 case
    through K1) and at its 28 ragged shapes."""
    import torch
    from repro_torch.kernels.irc_mvm import TILES
    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    for tag, C, B, pcx, pcg in K1_FULL_CASES:
        err, flips = check_layout(tag, ops_, C, B, pcx, pcg, gen,
                                  tiles=TILES)
        check(err == 0.0 and flips == 0, f"{tag}: tiles differ")
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for C, B, R, N, pcx, pcg in k1_ragged_cases():
        err, flips = check_layout(f"ragged C={C} B={B} R={R} N={N}", ops_,
                                  C, B, pcx, pcg, gen, shape=(R, N),
                                  tiles=TILES)
        check(err == 0.0 and flips == 0, f"ragged {C, B, R, N}: tiles "
              f"differ")
    torch.cuda.empty_cache()
    log("autotune", f"K1 tiles {list(TILES)}: counts exact, diff and "
        f"binary outputs bit-identical to the plain version at the "
        f"{len(K1_FULL_CASES)} full-width and {len(k1_ragged_cases())} "
        f"ragged shapes ({time.perf_counter() - t0:.1f}s)")


def autotune_sweep(ops_):
    """Phase `autotune` (b): the autotuner's sweep (`autotune.sweep`,
    CUDA events) of the proposed design's chunk and wave problems into a
    temporary table, never the committed one: each candidate tile and the
    plain route, timed whole; then each tile's bare K1 launch at the chunk
    problems beside its bound and the four-bmm yardstick; the winner per
    problem against the committed entry for this card.  Returns the
    measured records and the bare times."""
    import tempfile
    import torch
    from repro_torch.configs import yolo_irc
    from repro_torch.core.macro import DEFAULT_MACRO
    from repro_torch.kernels import autotune
    from repro_torch.kernels.irc_mvm import TILES
    from repro_torch.kernels.ref import IrcEpilogueParams
    cfg = yolo_irc.proposed()
    chunk = autotune.detector_problems(cfg, AUTOTUNE_BATCH, AUTOTUNE_CHIPS)
    wave = autotune.detector_problems(cfg, AUTOTUNE_WAVE_BATCH,
                                      SERVE_COMMITTEE)
    committed_bytes = autotune.TUNING_JSON.read_bytes()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tuning_")) / "tuning.json"
    t0 = time.perf_counter()
    layer = autotune.layer_problems(N_COLS, R_ROWS, K1_LAYER_CHUNK[1],
                                    K1_LAYER_CHUNK[0])
    measured = autotune.sweep(chunk + wave, write=True, path=tmp)
    measured.update(autotune.sweep(layer, write=True, path=tmp,
                                   per_chip_x=False))
    check(set(json.loads(tmp.read_text())) == set(measured)
          and autotune.TUNING_JSON.read_bytes() == committed_bytes,
          "the sweep must write its temporary table only")
    card = gpu_name_and_limit()
    prefix = tuning_prefix(torch.cuda.get_device_name(0))
    for key, rec in measured.items():
        check(key.startswith(prefix), f"sweep key {key} not this card's")
        tiles = ", ".join(f"{t} {us / 1e3:.3f}"
                          for t, us in rec["candidates_us"].items())
        log("autotune", f"{key}: route ms by tile: {tiles}; plain route "
            f"{rec['plain_us'] / 1e3:.3f}; winner bm={rec['bm']} "
            f"tm={rec['tm']} use_kernel={rec['use_kernel']}; {card}")
    log("autotune", f"sweep of {len(measured)} problems "
        f"({time.perf_counter() - t0:.1f}s) into {tmp}")
    verdicts = autotune_verdicts(measured, autotune.load_table())
    for key, got, want, verdict in verdicts:
        log("autotune", f"{key}: measured {got}, committed {want}: "
            f"{verdict}")
    params = IrcEpilogueParams.from_macro(DEFAULT_MACRO)
    bare = {}
    for C, M, N, K in chunk + layer:
        pcx = (C, M, N, K) not in layer
        ens, x, _ = autotune._problem(C, M, N, K, per_chip_x=pcx)
        gen = torch.Generator(device="cuda").manual_seed(M)
        eps = torch.randn((C, M, N), generator=gen, device="cuda")
        rnd = (torch.rand((C, M, N), generator=gen, device="cuda")
               < 0.5).float()
        ms = {}
        for tile in TILES:
            ms[f"{tile[0]}x{tile[1]}"] = cuda_ms(
                lambda: ops_.irc_mvm_chips(x, ens.ep, ens.en, ens.gp, ens.gn,
                                           eps, rnd, params, tile=tile))
        lib_ms = cuda_ms(bmm_yardstick(x, ens.ep, ens.en, ens.gp))
        b_ms, b_by = bound_ms(C, M, K, N, pcx, False)
        key = autotune.problem_key(C, M, N, K)
        bare[key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms,
                         plain_route_ms=measured[key]["plain_us"] / 1e3)
        log("autotune", f"{key}, {'per-chip' if pcx else 'shared'} x: K1 "
            f"alone ms by tile "
            + ", ".join(f"{t} {v:.3f}" for t, v in ms.items())
            + f"; bound {b_ms:.3f} ({b_by}); bmm yardstick {lib_ms:.3f}; "
            f"plain route {bare[key]['plain_route_ms']:.3f}")
        del ens, x, eps, rnd
        torch.cuda.empty_cache()
    return measured, bare


def autotune_routing(ops_):
    """Phase `autotune` (c): `run_ablation_detector` at full width (4
    chips, one chunk, columns ideal and all) with `use_kernel` None, True
    and False, launches from 0: under None K1 runs for exactly the group
    convs whose problem the committed table routes to it on this card
    (untuned: all 14 a chunk), under True 14 a chunk, under False none;
    per-chip mAPs of every pair of routes within MAP_NEAR_TIE.  Returns
    K1's launches under None."""
    import numpy as np
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.mc.detector_mc import run_ablation_detector
    from repro_torch.mc.engine import McConfig
    det, params, images, ev, key, columns = main_detector()
    cfg = det.cfg
    K = cfg.bias_rows + 9 * cfg.group
    routed, tiles = 0, []
    for _, _, s, _, ch in det.blocks():
        M = AUTOTUNE_BATCH * (cfg.img_hw[0] // 2 >> s) * (
            cfg.img_hw[1] // 2 >> s)
        problem = (AUTOTUNE_CHIPS, M, cfg.group, K)
        if autotune.kernel_wins(*problem):
            routed += ch // cfg.group
            tiles.append(autotune.best_blocks(*problem))
    mc = McConfig(n_chips=AUTOTUNE_CHIPS, chunk_size=AUTOTUNE_CHIPS)
    want = {None: routed, True: K1_PER_LANE, False: 0}
    maps, k1 = {}, {}
    for use_kernel in (None, True, False):
        torch.cuda.synchronize()
        ops_.reset_launches()
        t0 = time.perf_counter()
        res = run_ablation_detector(key, det, params, images, ev.boxes,
                                    ev.classes, ablations=columns, mc=mc,
                                    use_kernel=use_kernel)
        torch.cuda.synchronize()
        k1[use_kernel] = ops_.LAUNCHES["irc_mvm_chips"]
        maps[use_kernel] = {n: r.per_chip["map50"] for n, r in res.items()}
        log("autotune", f"run_ablation_detector use_kernel={use_kernel}: "
            f"K1 launches {k1[use_kernel]} (want {want[use_kernel]} x "
            f"{len(columns)} columns), threefry "
            f"{ops_.LAUNCHES['threefry']}, per-chip map50 "
            + "; ".join(f"{n} {v.tolist()}"
                        for n, v in maps[use_kernel].items())
            + f" ({time.perf_counter() - t0:.1f}s)")
        check(k1[use_kernel] == want[use_kernel] * len(columns),
              f"use_kernel={use_kernel}: K1 launches {k1[use_kernel]}")
        check(all(np.isfinite(v).all() and v.shape == (AUTOTUNE_CHIPS,)
                  for v in maps[use_kernel].values()),
              f"use_kernel={use_kernel}: bad per-chip mAPs")
    gap = max(float(np.max(np.abs(maps[a][n] - maps[b][n])))
              for a, b in ((None, True), (None, False), (True, False))
              for n in maps[a])
    log("autotune", f"auto routes {routed} of {K1_PER_LANE} group convs a "
        f"chunk to K1 (tiles {sorted(set(tiles))}); per-chip mAPs of the "
        f"three routes within {gap:.4f} (<= {MAP_NEAR_TIE})")
    check(gap <= MAP_NEAR_TIE, f"routes disagree: per-chip mAP gap {gap}")
    torch.cuda.empty_cache()
    return k1[None]


def phase_autotune(ops_):
    """Phase `autotune` (`--only autotune` runs it alone): (a)
    `autotune_tiles`, (b) `autotune_sweep`, (c) `autotune_routing`."""
    autotune_tiles(ops_)
    measured, bare = autotune_sweep(ops_)
    auto_k1 = autotune_routing(ops_)
    return {"measured": measured, "bare": bare, "auto_k1": auto_k1}


def trace_kernels(path):
    """Names of the CUDA kernel events in a `torch.profiler` Chrome trace."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def phase_cli():
    """Phase 7: the CLIs (the detector for both designs, the layer, the
    detector service with a trace), side by side, run to their end on the
    card, each mc CLI with its run directory under a temporary one; the
    detector also at `--det-backend plain` and `kernel`, its per-chip mAPs
    at the three backends within MAP_NEAR_TIE."""
    import shutil
    import numpy as np
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    runs = Path(tempfile.mkdtemp(prefix="chip_smoke_runs_"))
    mc_argvs = (["--network", "detector", "--chips", "4"],
                ["--network", "detector", "--det-scheme", "binary",
                 "--chips", "4", "--ablation", "table2"],
                ["--network", "layer", "--chips", "64", "--ablation",
                 "table2", "--backend", "kernel"],
                ["--network", "detector", "--chips", "16", "--ablation",
                 "table2", "--det-steps", "3"],
                ["--network", "detector", "--chips", "16", "--ablation",
                 "table2", "--det-steps", "20"],
                ["--network", "detector", "--chips", "16", "--det-steps",
                 "2", "--train-chips", "2"],
                ["--network", "detector", "--chips", "4", "--det-backend",
                 "plain"],
                ["--network", "detector", "--chips", "4", "--det-backend",
                 "kernel"])
    cmds = [("repro_torch.launch.mc", argv + ["--run-dir", str(runs),
                                             "--run-id", f"mc{i}"])
            for i, argv in enumerate(mc_argvs)]
    cmds.append(("repro_torch.launch.serve", [
        "--network", "detector", "--requests", str(SERVE_REQUESTS),
        "--slots", str(SERVE_SLOTS), "--committee", str(SERVE_COMMITTEE),
        "--det-backend", "kernel", "--run-dir", str(runs), "--run-id",
        "serve", "--trace"]))
    t0 = time.perf_counter()
    procs = [(argv, subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for module, argv in cmds]
    try:
        for argv, proc in procs:
            out, err = proc.communicate(timeout=600)
            lines = out.strip().splitlines()
            for line in (lines if "--det-steps" in argv or "--trace" in argv
                         else lines[-9:]):
                log("7 cli", line)
            check(proc.returncode == 0, err[-2000:])
            log("7 cli", f"{' '.join(argv)}: exit 0 within "
                f"{time.perf_counter() - t0:.1f}s")
        layer_run = runs / "mc2"
        files = sorted(p.name for p in layer_run.iterdir())
        log("7 cli", f"layer CLI run dir: {files}")
        check({"manifest.json", "metrics.jsonl", "results.csv"} <= set(files)
              and json.loads((layer_run / "manifest.json").read_text())[
                  "status"] == "ok", f"layer run dir {files}")
        # the detector at --det-backend auto (mc0), plain and kernel
        maps = {}
        for run in ("mc0", "mc6", "mc7"):
            rep = json.loads((runs / run / "report.json").read_text())
            maps[rep["args"]["det_backend"]] = {
                col: np.asarray(r["per_chip_map50"])
                for col, r in rep["results"]["init"].items()}
            check(rep["kernel_launches"]["irc_mvm_chips"] == 0
                  if rep["args"]["det_backend"] == "plain"
                  else rep["kernel_launches"]["irc_mvm_chips"] > 0,
                  f"{run}: launches {rep['kernel_launches']}")
        gap = max(float(np.max(np.abs(maps[a][c] - maps[b][c])))
                  for a in maps for b in maps for c in maps[a])
        shown = {b: {c: v.tolist() for c, v in m.items()}
                 for b, m in maps.items()}
        log("7 cli", f"detector CLI --det-backend auto / plain / kernel: "
            f"per-chip map50 {shown}, within {gap:.4f} (<= "
            f"{MAP_NEAR_TIE})")
        check(gap <= MAP_NEAR_TIE, f"--det-backend runs disagree: {gap}")
        names = trace_kernels(runs / "serve" / "trace" / "trace.json")
        k1 = sorted(n for n in names if "irc_mvm_chips_kernel" in n)
        log("7 cli", f"serve CLI trace: {len(names)} CUDA kernel names, "
            f"K1's: {[n[:80] for n in k1]}")
        check(bool(k1), f"no K1 kernel event in the serve trace; kernels "
              f"{sorted(names)[:20]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(runs, ignore_errors=True)


# phase `devices`: the measured device backend and retention drift
MEASURED_REPLACES = "src/repro/device/measured.py:98"
DEVICE_CHIPS, DEVICE_CHUNK, DEVICE_AGES = 8, 4, (0.0, 365.0)
LAYER_AGES = "0,30,365"
LINEAR_FAN_IN, LINEAR_FAN_OUT, LINEAR_BATCH = 1200, 64, 256


# Tables the measured tail is held on beside the packaged one (float64
# values, which `prng.check_table` rounds to float32): the fewest points;
# the most (`kMaxTable`, the normal cdf at 32 evenly spaced z); quantiles
# distinct in float64 but equal in float32 at the start, in the middle and
# at the end (empty segments, factors of both zero signs and below 0); and
# ends well inside the range of u, so both end clamps fire on many words.
_Z32 = tuple(-3.2 + 6.4 * i / 31 for i in range(32))
MEASURED_TABLES = {
    "two points": ((0.05, 0.95), (0.4, 2.5)),
    "32 points": (tuple(0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
                        for z in _Z32),
                  tuple(math.exp(0.4 * z) - 0.3 for z in _Z32)),
    "float32 ties": ((0.001, 0.001 + 1e-11, 0.1, 0.5, 0.5 + 1e-9, 0.7,
                      0.7 + 2e-9, 0.999 - 1e-11, 0.999),
                     (0.3, -0.0, 0.6, 1.0, 0.0, -1.5, 1.4, 2.0, 3.0)),
    "ends inside": ((0.3, 0.45, 0.5, 0.62, 0.7), (0.8, 0.9, 1.0, 1.1, 1.3)),
}


def measured_table():
    """The packaged dataset's variation table, as the measured tail takes
    it."""
    from repro_torch.device import MeasuredDeviceModel
    return MeasuredDeviceModel.from_file().table


def measured_tables():
    """{name: table} of every table the measured tail is held on, the
    packaged one first."""
    return {"packaged": measured_table(), **MEASURED_TABLES}


def devices_tail_check():
    """Phase `devices` (a): the measured tail on all 2^23 of its inputs
    (words k << 9 with low bits it ignores), in order and shuffled, through
    `threefry_measured_tail_launch` against `prng.tail_plain` on the card,
    bit for bit, for each table of `measured_tables`."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import threefry as kern
    t0 = time.perf_counter()
    k = torch.arange(1 << 23, dtype=torch.int64, device="cuda")
    words = (k << 9) | ((k * 0x9E3779B1) >> 7 & 511)
    perm = torch.randperm(1 << 23, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(61))
    factor = prng.normal_factor(prng.HALF_SQRT2)
    for name, table in measured_tables().items():
        table = prng.check_table(table)
        want = prng.tail_plain(words, "measured", table=table)
        for order, w, ref in (("in order", words, want),
                              ("shuffled", words[perm], want[perm])):
            got = kern.launch_tail(w, "measured", factor=factor,
                                   table=table)
            torch.cuda.synchronize()
            n = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            check(n == 0, f"measured tail, table {name!r}, {order}: {n} of "
                  f"2^23 inputs differ from tail_plain")
        ties = sum(a == b for a, b in zip(table[0], table[0][1:]))
        log("devices", f"measured tail, table {name!r} ({len(table[0])} "
            f"points, {ties} equal in float32, quantiles {table[0][0]:.6g}"
            f"..{table[0][-1]:.6g}): all 2^23 inputs, in order and "
            f"shuffled, bit-identical to tail_plain")
    log("devices", f"measured tail checks: {time.perf_counter() - t0:.1f}s")
    del k, words, perm, want
    torch.cuda.empty_cache()


# the measured main loop's SASS a word by these classes: constant and
# shared loads apart from the rest of memory
MEASURED_SASS = ("LDC", "LDS", "alu", "fma", "mufu/cvt", "control",
                 "memory", "other")


def measured_sass(source):
    """The measured draw's main loop (partitionable) in the build of
    `source`: (its SASS a word outside the vote-guarded blocks by
    MEASURED_SASS, those in the blocks a word, registers)."""
    info = threefry_sass(source, modes=(("measured", False),))["measured"]
    split = dict(info["per_word"])
    for head in ("LDC", "LDS"):
        n = sum(v for h, v in info["heads"].items() if h == head)
        split[head] = n
        split["memory"] = split.get("memory", 0.0) - n
    return ({c: split.get(c, 0.0) for c in MEASURED_SASS}, info["voted"],
            info["registers"])


def devices_times(baselines=()):
    """Phase `devices` (b): the measured tail's SASS a word by class (its
    main loop may load no constant a word, only the two a trip that every
    draw's loop reloads: the IMAD adds' 1 and the grid stride), then the
    measured draw at the periphery shape [4, 294912, 60] and at one
    512-die layer mask [512, 572, 60]: kernel (bit-identical to the plain
    version, with the packaged table and with "float32 ties"), plain
    version, torch.randn then torch.special.ndtr (two calls that give other
    bits), and the bound per pipe; each build of threefry.cu in
    `baselines` timed on the same draw in turns with the tree's (baseline,
    kernel, kernel, baseline), its output bit-identical to the kernel's.
    Returns {shape tag: numbers}."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import threefry as kern
    gen = torch.Generator(device="cuda").manual_seed(62)
    libs = {src.name: kern.load(src) for src in baselines}
    for name, src in [("tree", kern.SOURCE)] + [(s.name, s)
                                                 for s in baselines]:
        split, voted, regs = measured_sass(src)
        log("devices", f"measured main loop SASS a word, {name}: "
            f"{sum(split.values()):.2f} outside the vote-guarded blocks ("
            + ", ".join(f"{c} {v:.2f}" for c, v in split.items())
            + f"), {voted:.2f} in them; {regs} registers")
        if name == "tree":
            ldc, per_word = split["LDC"], sum(split.values())
    table = prng.check_table(measured_table())
    ties = prng.check_table(MEASURED_TABLES["float32 ties"])
    factor = prng.normal_factor(prng.HALF_SQRT2)
    root = prng.PRNGKey(5, device="cuda")
    out = {}
    for tag, n_keys, shape in (
            ("periphery", THREEFRY_KEYS, THREEFRY_SHAPE),
            ("mask", THREEFRY_MASK_KEYS, THREEFRY_MASK_SHAPE)):
        keys = prng.fold_in(root, torch.arange(n_keys, device="cuda"))
        n = math.prod(shape)
        full = (n_keys,) + shape
        call = lambda: prng.measured(keys, shape, table)
        plain = lambda: prng.measured_plain(keys, shape, table)
        check(same_bits(prng.measured(keys, shape, ties),
                        prng.measured_plain(keys, shape, ties)),
              f"measured draw {tag}, table 'float32 ties': differs from the "
              f"plain version")
        got, want = call(), plain()
        check(same_bits(got, want), f"measured draw {tag}: differs from "
              f"the plain version")
        err = float((got - want).abs().max())
        del want
        base_calls = {
            name: (lambda lib=lib: kern.launch_draw(
                keys, n, not prng.is_partitionable(), "measured",
                factor=factor, table=table, lib=lib))
            for name, lib in libs.items()}
        for name, base in base_calls.items():
            check(same_bits(base().view(got.shape), got),
                  f"measured draw {tag}: {name} differs from the kernel")
        del got
        torch.cuda.empty_cache()
        before = {name: queued_ms(b, reps=7, calls=20)[0]
                  for name, b in base_calls.items()}
        ms, host = queued_ms(call, reps=7, calls=20)
        again, _ = queued_ms(call, reps=7, calls=20)
        after = {name: queued_ms(b, reps=7, calls=20)[0]
                 for name, b in reversed(base_calls.items())}
        plain_ms = cuda_ms(plain, reps=3)
        lib_ms, _ = queued_ms(lambda: torch.special.ndtr(
            torch.randn(full, generator=gen, device="cuda")), reps=7,
            calls=20)
        b_ms, b_by, pipe = threefry_bound_ms("measured", n_keys, n, True)
        out[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        log("devices", f"measured draw {tag} {full}: kernel {ms:.4f} ms "
            f"(again {again:.4f}), plain {plain_ms:.3f} ms, torch.randn + "
            f"torch.special.ndtr (two calls, other bits) {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {pipe}: "
            f"{threefry_work('measured', True)} per word), share of bound "
            f"{b_ms / ms:.3f}, {per_word:.2f} SASS instructions per word in "
            f"the main loop, host enqueue {host:.4f} ms per call")
        for name in base_calls:
            log("devices", f"measured draw {tag} {full}: baseline {name} "
                f"{before[name]:.4f} ms before the kernel, "
                f"{after[name]:.4f} ms after, share of bound "
                f"{b_ms / max(before[name], after[name]):.3f}")
        torch.cuda.empty_cache()
    trip = threefry_words(kern.SOURCE)
    check(ldc * trip <= 2, f"measured main loop: {ldc * trip:g} constant "
          f"loads a trip of {trip} words, more than the loop's own two")
    return out


def pairs_times():
    """Phase `devices` (b'): the threefry kernel's pairs launch (fold_in,
    one block function a key, `threefry_pairs_launch`) at 4 keys (a chunk's
    chips) and 512 (a layer chunk's dies): device ms a launch, bit-identical
    to `prng.fold_in_plain`, beside that plain version, a 1-element torch
    add (the floor of one launch on the queue) and the bound: each key's
    16 bytes, its datum's 8 and the 16 written at 3.35 TB/s against its
    block function (41 ALU, 27 adds) on the pipes.  Returns {keys:
    numbers}."""
    import torch
    from repro_torch import prng
    root = prng.PRNGKey(5, device="cuda")
    one = torch.zeros(1, device="cuda")
    floor_ms, _ = queued_ms(lambda: one.add_(1.0), reps=7, calls=50)
    out = {}
    for n_keys in (THREEFRY_KEYS, THREEFRY_MASK_KEYS):
        keys = prng.fold_in(root, torch.arange(n_keys, device="cuda"))
        data = torch.arange(n_keys, device="cuda") * 7 + 3
        call = lambda: prng.fold_in(keys, data)
        check(same_values(call(), prng.fold_in_plain(keys, data)),
              f"pairs launch, {n_keys} keys: differs from fold_in_plain")
        ms, host = queued_ms(call, reps=7, calls=50)
        # the plain version waits on the card mid-call, so it cannot be
        # queued behind a sleep: CUDA events around one call
        plain_ms = cuda_ms(lambda: prng.fold_in_plain(keys, data), reps=7)
        t_bytes = 40 * n_keys / PEAK_BYTES_PER_S * 1e3
        blk = THREEFRY_BLOCK[True]
        t_ops = max(blk["alu"] / PIPE_RATE["alu"],
                    (blk["alu"] + blk["adds"]) / PIPE_RATE["issue"]) \
            * n_keys / SM_CLOCKS_PER_S * 1e3
        out[n_keys] = dict(ms=ms, floor_ms=floor_ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
        log("devices", f"threefry pairs launch (fold_in), {n_keys} keys: "
            f"{ms:.5f} ms a launch, its plain version "
            f"(`prng.fold_in_plain`) {plain_ms:.5f} ms, a 1-element torch "
            f"add {floor_ms:.5f} ms, bound {max(t_bytes, t_ops):.3g} ms "
            f"({out[n_keys]['bound_by']}), host enqueue {host:.4f} ms")
    return out


def devices_detector(ops_, main_maps):
    """Phase `devices` (c): the detector aging sweep at full width
    (`run_ablation_detector` on the main path's network, 2 images,
    DEVICE_CHIPS chips in chunks of DEVICE_CHUNK, columns ideal and all) on
    the measured device at each of DEVICE_AGES, launches counted from 0 for
    each age; then the analytic device at day 0, whose per-chip mAPs must
    be the main path's (`main_maps`; the main path's own call here when
    phase 5 did not run).  Returns the measured tail's launches."""
    import numpy as np
    import torch
    from repro_torch.device import get_device_model
    from repro_torch.mc.detector_mc import run_ablation_detector
    from repro_torch.mc.engine import McConfig
    det, params, images, ev, key, columns = main_detector()
    n_chunks = -(-DEVICE_CHIPS // DEVICE_CHUNK)
    want_k1 = 14 * n_chunks * len(columns)

    def sweep(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_.reset_launches()
        t0 = time.perf_counter()
        res = run_ablation_detector(
            key, det, params, images, ev.boxes, ev.classes,
            ablations=columns, mc=McConfig(n_chips=DEVICE_CHIPS,
                                           chunk_size=DEVICE_CHUNK,
                                           device=device), use_kernel=True)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, dict(ops_.LAUNCHES),
                dict(ops_.TAIL_LAUNCHES),
                torch.cuda.max_memory_allocated() / 2**30)

    measured = 0
    drift = {}
    for t in DEVICE_AGES:
        device = get_device_model("measured", t)
        res, wall, launches, tails, peak = sweep(device)
        measured += tails["measured"]
        drift[t] = tails["lognormal"]
        for name, r in res.items():
            m = r.metrics["map50"]
            check(np.isfinite(r.per_chip["map50"]).all()
                  and r.n_chips == DEVICE_CHIPS, f"{device.name} {name}: "
                  f"bad population result")
            log("devices", f"detector {device.name} {name}: map50 "
                f"{m['mean']:.4f}±{m['std']:.4f} over {r.n_chips} chips, "
                f"{r.chips_per_sec:.4f} chips/s steady, "
                f"{r.n_chips / r.wall_s:.4f} chips/s overall, wall_s "
                f"{r.wall_s:.3f}, enqueue_s {r.enqueue_s:.3f}, device_s "
                f"{r.device_s:.3f}, host_s {r.host_s:.3f}")
        log("devices", f"detector {device.name}, {DEVICE_CHIPS} chips in "
            f"chunks of {DEVICE_CHUNK}, columns {[c[0] for c in columns]}: "
            f"wall {wall:.2f}s, peak device memory {peak:.2f} GiB, "
            f"launches K1 {launches['irc_mvm_chips']} (want {want_k1}), "
            f"threefry {launches['threefry']}, of them the measured tail "
            f"{tails['measured']}, log-normal {tails['lognormal']} and "
            f"fold_in / split (pairs) "
            f"{launches['threefry'] - sum(tails.values())}; all {launches}")
        check(launches["irc_mvm_chips"] == want_k1
              and tails["measured"] >= 1, f"{device.name}: launches "
              f"{launches}, by tail {tails}")
        check_xla_launched(f"detector {device.name}", launches)
    # day 0 is the bare backend; a later age draws the drift as log-normal
    # masks beside the measured ones
    check(drift[0.0] == 0 and all(drift[t] >= 1 for t in DEVICE_AGES if t),
          f"drift draws by age: {drift}")
    res, _, launches, tails, _ = sweep(get_device_model("analytic", 0.0))
    check(tails["measured"] == 0, f"analytic: measured launches {tails}")
    if main_maps is None:
        ref, _, _, _, _ = sweep(None)
        main_maps = {n: r.per_chip["map50"] for n, r in ref.items()}
    for name, r in res.items():
        got = r.per_chip["map50"]
        want = main_maps[name][:DEVICE_CHIPS]
        check(np.array_equal(got, want), f"analytic@0 {name}: per-chip "
              f"mAPs {got.tolist()} differ from the main path's "
              f"{want.tolist()}")
    log("devices", f"detector analytic@t0: per-chip mAPs of chips 0-"
        f"{DEVICE_CHIPS - 1} equal the main path's in both columns")
    torch.cuda.empty_cache()
    return measured


def devices_layer(ops_):
    """Phase `devices` (d): the layer CLI's sweep at 540x60, 2048 dies in
    chunks of 512 through K1 (ideal bits through K3), columns ideal and
    all, on the measured device at LAYER_AGES; chips/s per age."""
    import tempfile
    from repro_torch.launch import mc as cli
    with tempfile.TemporaryDirectory(prefix="chip_smoke_layer_") as tmp:
        out = Path(tmp) / "layer.json"
        ops_.reset_launches()
        cli.main(["--network", "layer", "--chips", str(LAYER_CHIPS),
                  "--chunk", str(LAYER_CHUNK), "--backend", "kernel",
                  "--ablation", "all", "--device-model", "measured",
                  "--t-days", LAYER_AGES, "--run-dir", "", "--json",
                  str(out)])
        launches, tails = dict(ops_.LAUNCHES), dict(ops_.TAIL_LAUNCHES)
        report = json.loads(out.read_text())
    ages = LAYER_AGES.split(",")
    n_chunks = -(-LAYER_CHIPS // LAYER_CHUNK)
    want_k1 = n_chunks * 2 * len(ages)
    for label, r in report["results"].items():
        log("devices", f"layer {label}: agreement "
            f"{r['metrics']['bit_agreement']['mean']:.4f}, "
            f"{r['chips_per_sec']:.1f} chips/s steady, device model "
            f"{r['device_model']} at {r['t_days']:g} days")
    log("devices", f"layer sweep, {LAYER_CHIPS} dies in chunks of "
        f"{LAYER_CHUNK}, ages {LAYER_AGES}: launches K1 "
        f"{launches['irc_mvm_chips']} (want {want_k1}), K3 "
        f"{launches['ternary_matmul']}, threefry {launches['threefry']}, "
        f"the measured tail {tails['measured']}")
    check(launches["irc_mvm_chips"] == want_k1
          and launches["ternary_matmul"] >= 1 and tails["measured"] >= 1
          and len(report["results"]) == 2 * len(ages),
          f"layer sweep: launches {launches}, by tail {tails}")
    return tails["measured"]


def devices_irc_linear():
    """Phase `devices` (e): `IRCLinear(mode="eval")` for a layer of
    LINEAR_FAN_IN + 32 rows (two macros) on the card against the same call
    on the CPU, every effect on: decisions equal except where the CPU's
    margin (its summed sensed difference, or a line current's distance from
    the sensing window) is below NEAR_TIE_TOL."""
    import torch
    from repro_torch import prng
    from repro_torch.core import crossbar as cb
    from repro_torch.core.mapping import extend_inputs
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.kernels.ref import NEAR_TIE_TOL
    lin = cb.IRCLinear(cb.IRCLinearConfig(fan_in=LINEAR_FAN_IN,
                                          fan_out=LINEAR_FAN_OUT,
                                          bias_rows=32))
    cfg = NonidealConfig.all()
    params = lin.init(prng.PRNGKey(7, device="cuda"))
    x = torch.randn((LINEAR_BATCH, LINEAR_FAN_IN), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(8))
    t0 = time.perf_counter()
    got = lin.apply(params, x, key=prng.PRNGKey(9, device="cuda"),
                    mode="eval", cfg=cfg).cpu()
    card_s = time.perf_counter() - t0
    p_cpu = {"w": params["w"].cpu()}
    x_cpu, key = x.cpu(), prng.PRNGKey(9, device="cpu")
    want = lin.apply(p_cpu, x_cpu, key=key, mode="eval", cfg=cfg)
    spec, total, edge, lo = lin.spec, 0.0, None, 0
    bits = (x_cpu > 0).float()
    tiles = lin.map_to_planes(p_cpu)
    for t, tile in enumerate(tiles):
        x_t = bits[:, lo:lo + tile.fan_in]
        lo += tile.fan_in
        k_t = prng.fold_in(key, t)
        total = total + cb.crossbar_forward(k_t, x_t, tile, cfg=cfg,
                                            spec=spec, output="sensed_diff")
        ep, en, _ = cb.sample_chip_planes(k_t, tile.g_pos, tile.g_neg,
                                          tile.scheme, cfg, spec)
        x_e = extend_inputs(x_t, tile)
        i_pos, i_neg = (cb._accumulate(
            cb._block_reduce(x_e, e, spec.ir_block),
            cb._block_reduce(x_e, g, spec.ir_block), cfg, spec,
            "single_shot", 256)[0] for e, g in ((ep, tile.g_pos),
                                                 (en, tile.g_neg)))
        d = torch.minimum(
            (torch.minimum(i_pos, i_neg) - spec.sense_low_units).abs(),
            (torch.maximum(i_pos, i_neg) - spec.sense_high_units).abs())
        edge = d if edge is None else torch.minimum(edge, d)
    margin = torch.minimum(total.abs(), edge)
    mism = got != want
    n = int(mism.sum())
    log("devices", f"IRCLinear eval {LINEAR_BATCH}x{LINEAR_FAN_IN} -> "
        f"{LINEAR_FAN_OUT}, {len(tiles)} tiles, every effect: card vs CPU "
        f"{n} of {want.numel()} decisions differ, all near-ties "
        f"{bool((margin[mism] < NEAR_TIE_TOL).all())}; card call "
        f"{card_s:.3f}s")
    check(len(tiles) == 2 and (n == 0 or bool(
        (margin[mism] < NEAR_TIE_TOL).all())), f"IRCLinear: {n} flips "
        f"beyond the near-tie bar")


def phase_devices(ops_, main_maps=None, baselines=()):
    """Phase `devices`: the measured device backend and retention drift on
    the card (`--only devices` runs it alone); returns the measured tail's
    times by shape and its launches on the aging paths."""
    devices_tail_check()
    times = devices_times(baselines)
    pairs_times()
    launches = devices_detector(ops_, main_maps) + devices_layer(ops_)
    devices_irc_linear()
    return dict(times=times, launches=launches)


# phase `paper`: the paper's task end to end, through the port's twins of
# the JAX package's drivers (`repro_torch.examples`)
PAPER_TRAIN_ARGV = ("--full", "--steps", "4", "--batch", "2",
                    "--eval-batches", "1", "--mc-chips", "2", "--mc-chunk",
                    "1", "--designs", "proposed,baseline")
PAPER_MIN_AGREEMENT = 0.99


def paper_quickstart(ops_):
    """The quickstart on the card: K2 against the structural simulation
    (agreement >= PAPER_MIN_AGREEMENT), K3 for the ideal signs, threefry
    for every chip; returns its launches."""
    from repro_torch.examples import quickstart
    ops_.reset_launches()
    res = quickstart.main([])
    launches = dict(ops_.LAUNCHES)
    agree = res["kernel_agreement"]
    log("paper", f"quickstart: kernel vs structural sim agreement "
        f"{agree:.6f} (>= {PAPER_MIN_AGREEMENT}); effects "
        f"{ {k: round(v, 4) for k, v in res['effects'].items()} }; "
        f"launches {launches} (want irc_mvm >= 1, ternary_matmul >= 1, "
        f"threefry >= 1)")
    check(agree >= PAPER_MIN_AGREEMENT, f"quickstart: K2 agrees {agree}")
    check(launches["irc_mvm"] >= 1 and launches["ternary_matmul"] >= 1,
          f"quickstart launches {launches}")
    check_xla_launched("quickstart", launches)
    return launches


def paper_tables_rows(ops_):
    """Every row of the paper tables on the card, each with a finite time;
    K1 on the proposed smoke detector's sweeps, K3 for the ideal outputs,
    threefry for every chip; returns the launches."""
    import torch
    from repro_torch.examples import paper_tables
    ops_.reset_launches()
    t0 = time.perf_counter()
    rows = paper_tables.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops_.LAUNCHES)
    names = [r[0] for r in rows]
    log("paper", f"paper_tables: {len(rows)} rows of {len(paper_tables.ALL)}"
        f" functions in {wall:.1f}s, launches {launches} (want "
        f"ternary_matmul, irc_mvm_chips and threefry >= 1)")
    check(len(rows) == 26 and len(set(names)) == len(names)
          and all(math.isfinite(us) and us >= 0.0 for _, us, _ in rows),
          f"paper_tables rows {rows}")
    check(launches["ternary_matmul"] >= 1
          and launches["irc_mvm_chips"] >= 1, f"paper_tables {launches}")
    check_xla_launched("paper_tables", launches)
    return launches


def paper_train_detector(ops_):
    """`train_detector` at full width, both designs (PAPER_TRAIN_ARGV) into
    a temporary run directory: QAT, BN calibration and the five-column
    sweep of each; K1 14 a proposed chunk and none on the baseline, whose
    partial sums launch `xla_fma`; threefry on both sweeps.  Returns the
    launches of the whole run."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.examples import train_detector
    runs = Path(tempfile.mkdtemp(prefix="chip_smoke_paper_"))
    try:
        ops_.reset_launches()
        t0 = time.perf_counter()
        rep = train_detector.main(list(PAPER_TRAIN_ARGV) + [
            "--run-dir", str(runs), "--run-id", "paper"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops_.LAUNCHES)
        files = sorted(p.name for p in (runs / "paper").iterdir())
        manifest = json.loads((runs / "paper" / "manifest.json").read_text())
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    n_cols, chips = len(train_detector.ABLATION), 2
    chunks = n_cols * chips                      # --mc-chunk 1
    sweep = {d: rep["launches"][d]["sweep"] for d in rep["launches"]}
    log("paper", f"train_detector {' '.join(PAPER_TRAIN_ARGV)}: "
        f"{wall:.1f}s, Table II {rep['results']}, drops {rep['summary']}, "
        f"peak GiB {rep['peak_gib']}")
    for design in ("proposed", "baseline"):
        log("paper", f"train_detector {design}: launches qat "
            f"{rep['launches'][design]['qat']}, sweep {sweep[design]}")
    log("paper", f"train_detector run dir: {files}")
    check(all(np.isfinite(v).all() for cols in rep["per_chip"].values()
              for v in cols.values())
          and set(rep["summary"]) == {"drop_proposed", "drop_baseline"}
          and manifest["status"] == "ok" and "metrics.jsonl" in files
          and len([f for f in files if f.startswith("per_chip_")])
          == 2 * n_cols, f"train_detector run: {files}, {rep['summary']}")
    check(sweep["proposed"]["irc_mvm_chips"] == 14 * chunks,
          f"proposed sweep: K1 {sweep['proposed']['irc_mvm_chips']}, want "
          f"14 x {chunks}")
    check(sweep["baseline"]["irc_mvm_chips"] == 0,
          f"baseline sweep launched K1: {sweep['baseline']}")
    check_xla_launched("train_detector proposed sweep", sweep["proposed"])
    check_xla_launched("train_detector baseline sweep", sweep["baseline"],
                       XLA_PLAIN_ROUTE)
    return launches


def phase_paper(ops_):
    """Phase `paper` (`--only paper` runs it alone): the port's twins of
    the JAX package's drivers on the card, each with the launch counts
    set to 0 just before it and read just after; returns them by
    driver."""
    return {"quickstart": paper_quickstart(ops_),
            "tables": paper_tables_rows(ops_),
            "train_detector": paper_train_detector(ops_)}


# phase `lm`: the LM serving path (ckpt, the LM zoo's decode, ServeEngine,
# `launch.serve --network lm`); it runs no port of a TPU kernel but the
# threefry kernel (the init's normal leaves and split, the prompts' bits,
# the sampling's uniforms)
LM_DECODE_STEPS = 4
LM_SMOKE_ATOL, LM_SMOKE_RTOL = 1e-5, 1e-4
LM_WIDE = ("phi3-medium-14b", "hymba-1.5b", "rwkv6-3b")
LM_WIDE_RTOL = 1e-4             # and atol LM_WIDE_RTOL * max|ref|
LM_MOE = "qwen3-moe-235b-a22b"
LM_MOE_ATOL = 2e-2              # the reference's decode-vs-forward bar
LM_CLI = (("phi3-medium-14b", 8, 16), ("hymba-1.5b", 4, 8),
          ("rwkv6-3b", 4, 8))   # (arch, requests, max new tokens)
LM_SLOTS = 4
LM_WINDOW = 1 << 20             # counters per window of the big draw
LM_BIG_LEAF = ("phi3-medium-14b", "seg0_dense/mlp/w_gate")
LM_NEAR_TIE = 1e-4
LM_TEMPERATURE = 0.8


def lm_decode_bound(cfg, slots: int) -> dict:
    """The card's least time for one decode step at `slots` tokens: every
    parameter of `LM(cfg).specs()` read once (an untied embedding only
    gathers `slots` rows; a tied one is read whole as the unembedding), at
    PEAK_BYTES_PER_S; and the tokens/s that gives."""
    import torch
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.transformer import LM
    nbytes = 0
    for path, spec in tree_leaves_with_path(LM(cfg).specs()):
        size = torch.empty((), dtype=spec.dtype).element_size()
        rows = spec.shape[0] if path == ("embed",) \
            and not cfg.tie_embeddings else None
        words = math.prod(spec.shape)
        if rows is not None:
            words = words // rows * min(slots, rows)
        nbytes += words * size
    ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "ms": ms, "tokens_per_s": slots / ms * 1e3}


def threefry_window(key, n: int, a: int, b: int, partitionable: bool):
    """Words [a, b) of an n-word threefry draw under one key ([2] int64),
    computed plainly from their counters alone (int64 [b - a]):
    partitionable, word i is o0 ^ o1 at counters (i >> 32, i & mask);
    original, with h = (n + 1) // 2, word i < h is o0 at (i, i + h) and
    word i >= h is o1 at (i - h, i)."""
    import torch
    from repro_torch import prng
    idx = torch.arange(a, b, dtype=torch.int64, device=key.device)
    if partitionable:
        o0, o1 = prng.threefry2x32(key[0], key[1], idx >> 32,
                                   idx & prng.MASK32)
        return o0 ^ o1
    h = (n + 1) // 2
    first = idx < h
    x0 = torch.where(first, idx, idx - h)
    x1 = x0 + h
    x1 = torch.where(x1 < n, x1, torch.zeros_like(x1))
    o0, o1 = prng.threefry2x32(key[0], key[1], x0, x1)
    return torch.where(first, o0, o1)


def lm_windows(n: int, partitionable: bool, w: int = LM_WINDOW) -> list:
    """The counter windows held plainly: the first and last w words, w
    around 2**31 and, under the original scheme, around the halves'
    seam."""
    starts = [0, (1 << 31) - w // 2, n - w]
    if not partitionable:
        starts.append((n + 1) // 2 - w // 2)
    return [(max(0, s), min(n, s + w)) for s in starts if s < n]


def lm_cli_stats(lines) -> dict:
    """The `# lm stats` and `# kernel launches` lines of the serving CLI."""
    out = {}
    for line in lines:
        if line.startswith("# lm stats "):
            out.update(json.loads(line[len("# lm stats "):]))
        elif line.startswith("# kernel launches "):
            counts, tails = line[len("# kernel launches "):].split(" by tail ")
            out["launches"] = json.loads(counts)
            out["tail_launches"] = json.loads(tails)
    return out


def lm_samples(requests: int, slots: int, max_new: int) -> int:
    """Sampling calls of a run without EOS: each wave samples once after
    its prefill and once after each of its max_new decode steps."""
    return -(-requests // slots) * (max_new + 1)


def _lm_same_bits(a, b) -> bool:
    import torch
    from repro_torch.models.common import tree_leaves_with_path
    la = list(tree_leaves_with_path(a))
    lb = list(tree_leaves_with_path(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(
            x.cpu().view(torch.int16 if x.element_size() == 2
                         else torch.int32),
            y.cpu().view(torch.int16 if y.element_size() == 2
                         else torch.int32))
        for (_, x), (_, y) in zip(la, lb))


def _lm_decode(lm, params, toks, device):
    """Teacher-forced decode of toks [B, S] (numpy) on `device`: the
    stacked float32 logits [B, S, V] on the CPU."""
    import torch
    cache = lm.init_cache(toks.shape[0], 16, device=device)
    out = []
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(
            params, torch.from_numpy(toks[:, t:t + 1]).to(device), cache)
        out.append(logits[:, 0].float().cpu())
    return torch.stack(out, 1)


def lm_smoke_archs(ops_):
    """Step 1: every registered arch's smoke config, card against the port
    on the CPU: `LM.init(PRNGKey(0))` bit-identical (the threefry kernel
    against its plain version), LM_DECODE_STEPS decode steps within
    LM_SMOKE_ATOL + LM_SMOKE_RTOL.  Returns the card inits' launches."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.models.transformer import LM
    launches = 0
    for arch in list_archs():
        lm = LM(get_config(arch, "smoke"))
        ops_.reset_launches()
        card = lm.init(prng.PRNGKey(0, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        launches += ops_.LAUNCHES["threefry"]
        n_draws = ops_.TAIL_LAUNCHES["normal"]
        host = lm.init(prng.PRNGKey(0, device="cpu"), device="cpu")
        same = _lm_same_bits(card, host)
        toks = np.random.default_rng(0).integers(
            0, lm.cfg.vocab_size, (2, LM_DECODE_STEPS)).astype(np.int32)
        got = _lm_decode(lm, card, toks, "cuda")
        ref = _lm_decode(lm, host, toks, "cpu")
        err = float(torch.max(torch.abs(got - ref)))
        ok = bool(torch.all(torch.abs(got - ref)
                            <= LM_SMOKE_ATOL + LM_SMOKE_RTOL * ref.abs()))
        log("lm", f"{arch} smoke: init bit-identical card vs CPU {same} "
            f"({n_draws} normal draws + 1 split on the card); "
            f"{LM_DECODE_STEPS} decode steps max|diff| {err:.3e} within "
            f"{LM_SMOKE_ATOL} + {LM_SMOKE_RTOL}|ref| {ok}")
        check(same and ok, f"{arch} smoke: init {same}, decode {ok}")
    return launches


def lm_full_width(ops_):
    """Step 2: LM_WIDE at full width cut to 2 layers in float32: params
    drawn on the card and copied to the CPU, LM_DECODE_STEPS decode steps
    at batch 2 on both, logits within LM_WIDE_RTOL * (max|ref| + |ref|),
    greedy-token agreement printed.  Returns the card inits' launches."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import LM
    launches = 0
    for arch in LM_WIDE:
        cfg = dataclasses.replace(get_config(arch, "full"), n_layers=2,
                                  dtype="float32", param_dtype="float32")
        lm = LM(cfg)
        ops_.reset_launches()
        t0 = time.perf_counter()
        card = lm.init(prng.PRNGKey(0, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        launches += ops_.LAUNCHES["threefry"]
        host = tree_map(lambda t: t.cpu(), card)
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, LM_DECODE_STEPS)).astype(np.int32)
        t0 = time.perf_counter()
        got = _lm_decode(lm, card, toks, "cuda")
        card_s = time.perf_counter() - t0
        ref = _lm_decode(lm, host, toks, "cpu")
        top = float(ref.abs().max())
        err = float(torch.max(torch.abs(got - ref)))
        ok = bool(torch.all(torch.abs(got - ref)
                            <= LM_WIDE_RTOL * (top + ref.abs())))
        agree = float(torch.mean((got.argmax(-1) == ref.argmax(-1)).float()))
        log("lm", f"{arch} full width, 2 layers, float32 "
            f"({cfg.param_count() / 1e9:.3f}e9 params, init {init_s:.2f}s "
            f"on the card): {LM_DECODE_STEPS} decode steps at batch 2, "
            f"max|diff| {err:.3e} (max|ref| {top:.3e}) within "
            f"{LM_WIDE_RTOL} (max|ref| + |ref|) {ok}; greedy tokens agree "
            f"{agree:.4f}; card decode {card_s:.3f}s")
        check(ok, f"{arch} full width card vs CPU: {err} of {top}")
        del card, host
        torch.cuda.empty_cache()
    return launches


def lm_moe(ops_):
    """Step 3: LM_MOE at full width cut to 2 layers, float32, on the card:
    decode against the teacher-forced forward within LM_MOE_ATOL, and the
    assignments dropped for capacity at the forward's and at a 128-token
    batch.  Returns the init's launches."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import LM
    cfg = dataclasses.replace(get_config(LM_MOE, "full"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops_.reset_launches()
    params = lm.init(prng.PRNGKey(0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    launches = ops_.LAUNCHES["threefry"]
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 5)).astype(np.int32)
    full, _ = lm.apply(params, torch.from_numpy(toks).cuda())
    steps = _lm_decode(lm, params, toks, "cuda")
    err = float(torch.max(torch.abs(full.cpu() - steps)))
    layer = {k: v[0] for k, v in params["seg0_moe"]["moe"].items()}
    drops = {}
    for shape in ((1, 5), (2, 64)):
        x = torch.randn(shape + (cfg.d_model,), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        _, aux = moe_mod.moe_block(layer, x, cfg)
        drops[shape[0] * shape[1]] = (int(aux["dropped"]),
                                      moe_mod._capacity(cfg, x.shape[0]
                                                        * x.shape[1]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("lm", f"{LM_MOE} full width, 2 layers, float32 "
        f"({cfg.param_count() / 1e9:.3f}e9 params, peak {peak:.2f} GiB): "
        f"decode vs teacher-forced forward max|diff| {err:.3e} (<= "
        f"{LM_MOE_ATOL}); assignments dropped for capacity by tokens: "
        f"{ {t: f'{d} of {t * cfg.top_k} (capacity {c})' for t, (d, c) in drops.items()} }")
    check(err <= LM_MOE_ATOL, f"{LM_MOE}: decode vs forward {err}")
    del params
    torch.cuda.empty_cache()
    return launches


def lm_threefry_windows(ops_):
    """Step 4: the phi3-medium-14b init's largest leaf (LM_BIG_LEAF,
    3.67e9 words under one key, past 2**31) drawn by the threefry kernel
    under both schemes at its own key, held bit for bit against the plain
    computation of the words in each of `lm_windows` (the whole plain draw
    would need ~29 GB of int64); the partitionable draw timed against its
    bound (the float32 output written once)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.transformer import LM
    arch, leaf = LM_BIG_LEAF
    specs = list(tree_leaves_with_path(LM(get_config(arch, "full")).specs()))
    i = ["/".join(p) for p, _ in specs].index(leaf)
    shape = specs[i][1].shape
    n = math.prod(shape)
    out = {}
    for partitionable in (True, False):
        with prng.threefry_partitionable(partitionable):
            key = prng.split(prng.PRNGKey(0, device="cuda"), len(specs))[i]
            draw = prng.normal(key, shape).view(-1)
            ms = cuda_ms(lambda: prng.normal(key, shape), reps=3) \
                if partitionable else float("nan")
            rows = []
            for a, b in lm_windows(n, partitionable):
                want = prng.tail_plain(
                    threefry_window(key, n, a, b, partitionable), "normal")
                same = torch.equal(draw[a:b].view(torch.int32),
                                   want.view(torch.int32))
                rows.append((a, b, same))
            del draw
            torch.cuda.empty_cache()
        scheme = "partitionable" if partitionable else "original"
        bound = 4 * n / PEAK_BYTES_PER_S * 1e3
        log("lm", f"threefry normal {leaf} {shape} = {n} words under one "
            f"key ({scheme}): windows bit-identical to the plain words "
            f"{[(a, b, s) for a, b, s in rows]}"
            + (f"; {ms:.3f} ms (bound {bound:.3f} ms: 4 bytes a word "
               f"written)" if partitionable else ""))
        check(all(s for _, _, s in rows), f"threefry windows ({scheme}) "
              f"differ: {rows}")
        out[scheme] = ms
    return out


def _lm_cli(argv, runs, tag, env):
    """`python -m repro_torch.launch.serve --network lm ARGV` into a run
    dir under `runs`; its printed lines and stats."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--network", "lm",
         *argv, "--run-dir", str(runs), "--run-id", tag], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"serve {' '.join(argv)}: "
          f"{proc.stderr[-2000:]}")
    stats = lm_cli_stats(lines)
    stats["process_s"] = wall
    stats["files"] = sorted(p.name for p in (runs / tag).iterdir())
    stats["lines"] = [l for l in lines if not l.startswith("# lm stats")]
    return stats


def lm_cli_full(runs, env):
    """Step 5: the CLI at full width and full depth in bfloat16 for each of
    LM_CLI, one after another: every request gets its tokens, all in the
    vocabulary, the logits finite; tokens/s, first wave, peak memory and
    the init's threefry launches printed beside the decode bound."""
    from repro_torch.configs.registry import get_config
    card = gpu_name_and_limit()
    out = {}
    for arch, requests, max_new in LM_CLI:
        argv = ["--arch", arch, "--variant", "full", "--requests",
                str(requests), "--slots", str(LM_SLOTS), "--max-new",
                str(max_new)]
        st = _lm_cli(argv, runs, f"full-{arch}", env)
        for line in st["lines"]:
            log("lm", f"serve {arch} full: {line}")
        bound = lm_decode_bound(get_config(arch, "full"), LM_SLOTS)
        log("lm", f"serve {arch} full ({st['params'] / 1e9:.3f}e9 params, "
            f"{st['param_dtype']}), {requests} requests x {max_new} new "
            f"tokens at {LM_SLOTS} slots: steady decode "
            f"{st['decode_tokens_per_sec']:.2f} tok/s (bound "
            f"{bound['tokens_per_s']:.1f}: {bound['bytes'] / 1e9:.2f} GB of "
            f"weights a step in {bound['ms']:.3f} ms), prefill "
            f"{st['prefill_tokens_per_sec']:.2f} tok/s, first wave "
            f"{st['first_wave_s']:.3f} s, init {st['init_s']:.2f} s with "
            f"{st['init_threefry_launches']} threefry launches, peak "
            f"{st['init_peak_gib']:.2f} GiB at init and "
            f"{st['serve_peak_gib']:.2f} GiB serving; process "
            f"{st['process_s']:.1f} s; run dir {st['files']}; {card}")
        check(st["requests"] == requests
              and st["new_tokens"] == requests * max_new
              and all(len(t) == max_new for t in st["tokens"])
              and st["in_vocab"] and st["logits_finite"]
              and {"manifest.json", "metrics.jsonl"} <= set(st["files"]),
              f"serve {arch} full: {st}")
        manifest = json.loads((runs / f"full-{arch}" / "manifest.json")
                              .read_text())
        check(manifest["status"] == "ok", f"{arch} manifest {manifest}")
        out[arch] = st
    return out


def _lm_cpu_gaps(engine, temperature):
    """Wrap a CPU engine's `_sample` to record, per call, the top-2 gap of
    the scores it samples from (logits, or gumbel + logits / T)."""
    import torch
    from repro_torch import prng
    inner = engine._sample
    gaps = []

    def sample(logits, *, wave, step):
        last = logits[:, -1, :]
        if temperature > 0:
            k = prng.fold_in(prng.fold_in(engine._root_key, wave), step)
            last = prng.gumbel(k, tuple(last.shape)) + last / torch.tensor(
                float(temperature))
        top = torch.topk(last, 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).tolist())
        return inner(logits, wave=wave, step=step)
    engine._sample = sample
    return gaps


def lm_tokens_agree(card_tokens, cpu_tokens, gaps, slots, max_new):
    """Card tokens equal the CPU's per request up to the first sampling
    step where the CPU's top-2 gap is under LM_NEAR_TIE; returns (compared,
    near-ties, mismatches)."""
    compared = ties = bad = 0
    for r, (a, b) in enumerate(zip(card_tokens, cpu_tokens)):
        wave, slot = divmod(r, slots)
        for s in range(len(b)):
            if gaps[wave * (max_new + 1) + s][slot] < LM_NEAR_TIE:
                ties += 1
                break
            compared += 1
            bad += s >= len(a) or a[s] != b[s]
    return compared, ties, bad


def lm_cli_smoke(ops_, runs, env):
    """Steps 6 and 7, at the smoke config: the port's CheckpointManager
    saves random phi3 smoke params (PRNGKey(3)) in bfloat16 and in
    float32; the CLI restores each (`restored step`) and serves the same
    greedy tokens as an in-process ServeEngine on the restored params;
    the CLI at --temperature LM_TEMPERATURE launches the threefry uniform
    once a sampling step, its tokens equal to a CPU engine's up to counted
    near-ties.  The three CLIs run side by side.  Returns their
    launches."""
    import torch
    from repro_torch import prng
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import LM
    from repro_torch.serve import ServeEngine
    arch, requests, max_new, slots = "phi3-medium-14b", 6, 6, 2
    lm = LM(get_config(arch, "smoke"))
    other = lm.init(prng.PRNGKey(3, device="cuda"), device="cuda")
    dirs = {}
    for dtype in (torch.bfloat16, torch.float32):
        d = runs / f"ckpt-{str(dtype).split('.')[-1]}"
        CheckpointManager(d).save(tree_map(lambda t: t.to(dtype), other), 11)
        dirs[dtype] = d
    base = ["--requests", str(requests), "--slots", str(slots),
            "--max-new", str(max_new)]
    jobs = {str(dt).split(".")[-1]: base + ["--ckpt-dir", str(d)]
            for dt, d in dirs.items()}
    jobs["sampled"] = base + ["--temperature", str(LM_TEMPERATURE)]
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--network", "lm",
         *argv, "--run-dir", str(runs), "--run-id", tag], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, argv in jobs.items()}
    stats = {}
    try:
        for tag, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"serve {tag}: {err[-2000:]}")
            stats[tag] = lm_cli_stats(out.splitlines())
            stats[tag]["lines"] = out.splitlines()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    prompts = lm_prompts(requests, lm.cfg.vocab_size, "cuda")
    for dtype, d in dirs.items():
        tag = str(dtype).split(".")[-1]
        restored, step = CheckpointManager(d).restore_latest(
            lm.abstract_params(), device="cuda")
        eng = ServeEngine(lm, restored, batch_slots=slots, max_len=128)
        want = [r.tokens for r in eng.generate(prompts, max_new)]
        said = f"restored step 11 from {d}" in stats[tag]["lines"]
        log("lm", f"--ckpt-dir ({tag} checkpoint, step {step}): CLI printed "
            f"'restored step 11' {said}; its tokens equal the in-process "
            f"engine's on the restored params "
            f"{stats[tag]['tokens'] == want} ({stats[tag]['tokens'][:2]}...)")
        check(said and stats[tag]["tokens"] == want,
              f"--ckpt-dir {tag}: {stats[tag]['tokens']} vs {want}")
    st = stats["sampled"]
    want_u = lm_samples(requests, slots, max_new)
    host_lm = LM(get_config(arch, "smoke"))
    host = host_lm.init(prng.PRNGKey(0, device="cpu"), device="cpu")
    cpu = ServeEngine(host_lm, host, batch_slots=slots, max_len=128,
                      temperature=LM_TEMPERATURE)
    gaps = _lm_cpu_gaps(cpu, LM_TEMPERATURE)
    cpu_tokens = [r.tokens for r in cpu.generate(
        lm_prompts(requests, host_lm.cfg.vocab_size, "cpu"), max_new)]
    compared, ties, bad = lm_tokens_agree(st["tokens"], cpu_tokens, gaps,
                                          slots, max_new)
    log("lm", f"--temperature {LM_TEMPERATURE}: threefry launches "
        f"{st['launches']['threefry']} (uniform tail "
        f"{st['tail_launches']['uniform']}, want {want_u}: one a sampling "
        f"step), tokens equal the CPU engine's at {compared - bad} of "
        f"{compared} compared steps, {ties} near-ties (top-2 gap < "
        f"{LM_NEAR_TIE})")
    check(st["tail_launches"]["uniform"] == want_u and bad == 0
          and compared > 0, f"sampled CLI: uniform "
          f"{st['tail_launches']['uniform']} (want {want_u}), "
          f"{bad} mismatches")
    del other
    torch.cuda.empty_cache()
    return {tag: s["launches"] for tag, s in stats.items()}


def lm_step_profile():
    """Step 8, a measurement: phi3-medium-14b at full width and depth in
    bfloat16 (LM_SLOTS slots, a 128-position cache): one decode step's
    wall time (host clock around steps that end in a synchronize), its
    device span (CUDA events) and torch.profiler's kernels of one step by
    name (the matmuls apart), their sum the card's busy time, beside the
    decode bound.  (`queued_ms` cannot time it: a step's ~3,000 launches
    overflow the launch queue behind any sleep.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM
    cfg = get_config(LM_BIG_LEAF[0], "full")
    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(0, device="cuda"), device="cuda")
    cache = lm.init_cache(LM_SLOTS, 128, device="cuda")
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device="cuda")

    def step():
        return lm.decode_step(params, tok, {**cache, "index": 5})
    span_ms = cuda_ms(step, reps=5)
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted((e for e in prof.key_averages()
                   if not e.key.startswith("aten::") and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    mm = [e for e in rows if any(w in e.key.lower() for w in
                                 ("gemm", "gemv", "nvjet", "cutlass",
                                  "sm90_", "xmma", "cublas"))]
    mm_ms = sum(dev_us(e) for e in mm) / 1e3
    bound = lm_decode_bound(cfg, LM_SLOTS)
    log("lm", f"{cfg.name} full, one decode step at {LM_SLOTS} slots: wall "
        f"{wall_ms:.3f} ms, device span {span_ms:.3f} ms (CUDA events), "
        f"kernels {busy_ms:.3f} ms in {launches} launches (card idle "
        f"{1 - busy_ms / wall_ms:.4f} of the wall), matmuls {mm_ms:.3f} ms "
        f"in {sum(e.count for e in mm)} launches; bound {bound['ms']:.3f} "
        f"ms (bytes); {gpu_name_and_limit()}")
    for e in rows[:8]:
        log("lm", f"  {dev_us(e) / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}")
    del params, cache
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": busy_ms,
            "launches": launches, "matmul_ms": mm_ms}


def phase_lm(ops_):
    """Phase `lm` (`--only lm` runs it alone): the LM serving path on the
    card, steps 1-7 of `lm_smoke_archs`, `lm_full_width`, `lm_moe`,
    `lm_threefry_windows`, `lm_cli_full` and `lm_cli_smoke`, TF32 checked
    off first, and the measurement `lm_step_profile`.  Every launch
    counted on these paths is the threefry kernel's (this path runs no
    port of a TPU kernel); returns them."""
    import shutil
    import tempfile
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the float32 legs would not be true float32")
    torch.cuda.empty_cache()
    log("lm", f"TF32 off (matmul and cuDNN); {gpu_name_and_limit()}")
    t0 = time.perf_counter()
    launches = {"smoke": lm_smoke_archs(ops_),
                "full_width": lm_full_width(ops_), "moe": lm_moe(ops_)}
    windows = lm_threefry_windows(ops_)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    runs = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    try:
        full = lm_cli_full(runs, env)
        smoke = lm_cli_smoke(ops_, runs, env)
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    step = lm_step_profile()
    for arch, st in full.items():
        launches[f"cli {arch}"] = st["launches"]["threefry"]
    for tag, counts in smoke.items():
        launches[f"cli {tag}"] = counts["threefry"]
    others = {k: v for st in full.values() for k, v in st["launches"].items()
              if k != "threefry" and v}
    check(not others, f"the LM path launched other kernels: {others}")
    log("lm", f"threefry launches on the LM paths {launches}; "
        f"{time.perf_counter() - t0:.1f}s")
    return {"threefry": sum(launches.values()), "by_path": launches,
            "full": full, "windows": windows, "step": step}


# phase `train_lm`: LM training (train/steps.py's LM half with remat and
# microbatching, the associative SSM scan, Trainer, `launch.train`, the LM
# examples); its kernels are threefry (the init's draws) and xla_fma (the
# scan's fused multiply-add, on the hybrid configs)
TRAIN_LM_ATOL, TRAIN_LM_RTOL = 1e-5, 1e-4      # the loss, card vs CPU
TRAIN_LM_GRAD_RTOL = {False: 1e-5, True: 1e-3}  # relative L2 per leaf
TRAIN_LM_LR = 1e-3
TRAIN_LM_WIDE = ("hymba-1.5b", "musicgen-medium", "rwkv6-3b")
TRAIN_LM_WIDE_SHAPE = (2, 64)                  # (rows, seq), 2 layers, f32
TRAIN_LM_FULL = ("--variant", "full", "--batch", "8", "--seq", "4096",
                 "--microbatch", "4", "--remat", "block")
TRAIN_LM_STEPS = 8                # hymba-1.5b's timed run, no checkpoints
# the resume and --irc runs check the checkpoint round trip and the IRC
# path at full width and depth; 2 x 1024 tokens a step (1/16 of the timed
# run's) keep their steps short, for the time of phase `analysis`
TRAIN_LM_SHORT = ("--variant", "full", "--batch", "2", "--seq", "1024",
                  "--microbatch", "1", "--remat", "block")
# a full-width checkpoint is 14.75 GB (bf16 params, float32 m and v); the
# CLI saves every steps // 4 steps and keeps 3, so the 8-step run would
# write 4 (59 GB): the resume runs 1 -> 2 steps instead, 2 saves (29.5 GB)
# under the phase's temporary directory, to keep the phase's disk writes
# under 45 GiB
TRAIN_LM_RESUME_STEPS = (1, 2)
TRAIN_LM_IRC_STEPS = 2
TRAIN_LM_MUSICGEN_STEPS = 3       # fewer than 8: the phase's wall
TRAIN_LM_REMAT = ("none", "names", "dots", "block")
TRAIN_LM_REMAT_SHAPE = (1, 1024)  # (batch, seq) of the remat peaks
TRAIN_LM_PROFILE_SHAPE = (2, 4096)  # one micro-slice of the full run
TRAIN_LM_EXAMPLE = ("--size", "100m", "--steps", "50")


def train_flops_share(params: int, tokens: int, step_s: float) -> float:
    """The model-FLOPs share of a step: 6 * params * tokens (forward and
    backward of every weight, no recompute, no attention) over the step's
    wall and PEAK_BF16_FLOPS."""
    return 6.0 * params * tokens / step_s / PEAK_BF16_FLOPS


def train_stats(lines) -> dict:
    """The `# train stats` and `# kernel launches` lines of the training
    CLI, and its last line."""
    out = {"last": lines[-1] if lines else ""}
    for line in lines:
        if line.startswith("# train stats "):
            out.update(json.loads(line[len("# train stats "):]))
        elif line.startswith("# kernel launches "):
            counts, tails = line[len("# kernel launches "):].split(" by tail ")
            out["launches"] = json.loads(counts)
            out["tail_launches"] = json.loads(tails)
    return out


def log_train_stats(tag: str, st: dict, card: str) -> dict:
    """Print one `# train stats` line (steady steps/s and tokens/s,
    compile_s, peak memory, the losses, the model-FLOPs share) beside the
    card; returns it."""
    steady = st["step_times_s"][1:] or st["step_times_s"]
    step_s = statistics.median(steady)
    line = {"run": tag, "arch": st["arch"], "params": st["params"],
            "tokens_per_step": st["tokens_per_step"],
            "steps": st["steps"], "resumed_at": st["resumed_at"],
            "steps_per_sec": st["steps_per_sec"],
            "tokens_per_sec": st["tokens_per_sec"],
            "median_step_s": step_s, "compile_s": st["compile_s"],
            "peak_gib": st["peak_gib"], "losses": st["losses"],
            "model_flops_share": train_flops_share(
                st["params"], st["tokens_per_step"], step_s),
            "card": card}
    print(f"# train stats {json.dumps(line)}", flush=True)
    return line


def _rel_l2(got, want) -> float:
    import torch
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.norm(got - want)
                 / max(float(torch.linalg.norm(want)), 1e-30))


def _train_batch(vocab: int, rows: int, seq: int, seed: int, device):
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(
        0, vocab, (rows, seq + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
            "labels": torch.from_numpy(toks[:, 1:]).to(device)}


def _card_vs_cpu_grads(lm, card_params, rows, seq, seed, rtol):
    """One `value_and_grad` of `lm.loss` on the card (remat "block") and
    on the CPU (remat "none") from the same params: (loss error, worst
    leaf (relative L2, path)); checks them against TRAIN_LM_* / rtol."""
    from repro_torch.models.common import tree_leaves_with_path, tree_map
    from repro_torch.train.steps import value_and_grad
    host = tree_map(lambda t: t.cpu(), card_params)
    vocab = lm.cfg.vocab_size
    lc, _, gc = value_and_grad(lm, card_params,
                               _train_batch(vocab, rows, seq, seed, "cuda"),
                               remat="block")
    lh, _, gh = value_and_grad(lm, host,
                               _train_batch(vocab, rows, seq, seed, "cpu"),
                               remat="none")
    lerr = abs(float(lc) - float(lh))
    worst = max((_rel_l2(a, b), "/".join(p)) for (p, a), (_, b) in
                zip(tree_leaves_with_path(gc), tree_leaves_with_path(gh)))
    check(lerr <= TRAIN_LM_ATOL + TRAIN_LM_RTOL * abs(float(lh))
          and worst[0] <= rtol and math.isfinite(float(lc)),
          f"{lm.cfg.name}: loss {float(lc)} vs {float(lh)}, worst grad "
          f"{worst}")
    del gc, gh
    return lerr, worst


def train_lm_smoke(ops_):
    """Step 1: every registered arch's smoke config with IRC off and on:
    one value_and_grad card ("block") against the CPU ("none") from the
    same params (`LM.init(PRNGKey(0))` on the card, copied), then one
    `make_train_step` on the card (step 1, finite metrics)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.models.common import scalar
    from repro_torch.models.lm_config import IRCMode
    from repro_torch.models.transformer import LM
    from repro_torch.train.steps import init_train_state, make_train_step
    lr = scalar(TRAIN_LM_LR, torch.float32, torch.device("cuda"))
    for arch in list_archs():
        for irc in (False, True):
            cfg = get_config(arch, "smoke")
            if irc:
                cfg = dataclasses.replace(cfg, irc=IRCMode(enabled=True))
            lm = LM(cfg)
            state = init_train_state(lm, prng.PRNGKey(0, device="cuda"),
                                     device="cuda")
            lerr, worst = _card_vs_cpu_grads(lm, state.params, 2, 8, 0,
                                             TRAIN_LM_GRAD_RTOL[irc])
            new, m = make_train_step(lm, remat="block", lr_fn=lambda s: lr)(
                state, _train_batch(cfg.vocab_size, 2, 8, 0, "cuda"))
            ok = int(new.step) == 1 and all(
                math.isfinite(float(v)) for v in m.values())
            log("train_lm", f"{arch} smoke, irc {irc}: loss card vs CPU "
                f"|diff| {lerr:.3e}, worst gradient rel L2 {worst[0]:.3e} "
                f"({worst[1]}) within {TRAIN_LM_GRAD_RTOL[irc]}; one step "
                f"on the card: step {int(new.step)}, loss "
                f"{float(m['loss']):.6f}, grad_norm "
                f"{float(m['grad_norm']):.4f}")
            check(ok, f"{arch} smoke irc {irc}: the card's step {m}")


def train_lm_wide():
    """Step 2: TRAIN_LM_WIDE at full width cut to 2 layers in float32: one
    value_and_grad card against CPU from the same params at
    TRAIN_LM_WIDE_SHAPE."""
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM
    rows, seq = TRAIN_LM_WIDE_SHAPE
    for arch in TRAIN_LM_WIDE:
        cfg = dataclasses.replace(get_config(arch, "full"), n_layers=2,
                                  dtype="float32", param_dtype="float32")
        lm = LM(cfg)
        params = lm.init(prng.PRNGKey(0, device="cuda"), device="cuda")
        t0 = time.perf_counter()
        lerr, worst = _card_vs_cpu_grads(lm, params, rows, seq, 1,
                                         TRAIN_LM_GRAD_RTOL[False])
        log("train_lm", f"{arch} full width, 2 layers, float32 "
            f"({cfg.param_count() / 1e9:.3f}e9 params), batch {rows} x "
            f"{seq}: loss card vs CPU |diff| {lerr:.3e}, worst gradient rel "
            f"L2 {worst[0]:.3e} ({worst[1]}) within "
            f"{TRAIN_LM_GRAD_RTOL[False]}; {time.perf_counter() - t0:.1f}s")
        del params
        torch.cuda.empty_cache()


def train_lm_scan_fma():
    """Step 2b: xla_fma at the operands of the scan's first level in the
    full run's micro-slice (TRAIN_LM_PROFILE_SHAPE) at hymba-1.5b's full
    width: bl * ar + br on the stride-2 views of [rows, seq, d_inner,
    state] float32 that `ssm._combine` gives it, bit for bit (0 ulp)
    against `fma_plain` on the same inputs."""
    import torch
    from repro_torch import xla_order as xo
    from repro_torch.configs.registry import get_config
    cfg = get_config("hymba-1.5b", "full")
    rows, seq = TRAIN_LM_PROFILE_SHAPE
    shape = (rows, seq, cfg.d_inner_ssm, cfg.ssm_state)
    gen = torch.Generator(device="cuda").manual_seed(28)
    a_bar = torch.rand(shape, generator=gen, device="cuda")
    bx = torch.randn(shape, generator=gen, device="cuda")
    bl, ar, br = bx[:, 0:seq - 1:2], a_bar[:, 1::2], bx[:, 1::2]
    got = xo.fma(bl, ar, br)
    want = xo.fma_plain(bl, ar, br)
    torch.cuda.synchronize()
    differ = int((got != want).sum())
    check(same_bits(got, want) and got.shape == bl.shape,
          f"xla_fma at the scan's first level {tuple(bl.shape)} strides "
          f"{bl.stride()}: {differ} elements differ from fma_plain")
    log("train_lm", f"xla_fma at the scan's first level, hymba-1.5b full "
        f"({tuple(bl.shape)}, stride-2 views of {shape} float32, strides "
        f"{bl.stride()}): bit-identical to fma_plain ({differ} of "
        f"{got.numel()} differ)")
    del a_bar, bx, bl, ar, br, got, want
    torch.cuda.empty_cache()


def _train_cli(argv, runs, tag, env):
    """`python -m repro_torch.launch.train ARGV` into the run dir
    runs/tag: its stats, lines, run-dir files and event kinds; checks the
    exit code, the manifest's status, finite losses and the last line's
    wording."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--run-dir", str(runs), "--run-id", tag], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"train {' '.join(argv)}: "
          f"{proc.stderr[-3000:]}")
    st = train_stats(lines)
    st["process_s"] = wall
    st["lines"] = [l for l in lines if not l.startswith("# ")]
    st["files"] = sorted(p.name for p in (runs / tag).iterdir())
    st["kinds"] = [json.loads(l)["kind"] for l in
                   (runs / tag / "metrics.jsonl").read_text().splitlines()]
    manifest = json.loads((runs / tag / "manifest.json").read_text())
    check(manifest["status"] == "ok"
          and st["last"].startswith("final loss ")
          and all(math.isfinite(x) for x in st["losses"]),
          f"train {tag}: {manifest['status']}, {st['last']}, "
          f"{st['losses']}")
    return st


def train_lm_cli(runs, env, card):
    """Step 3: `launch.train` at full width and depth, one run after
    another: hymba-1.5b TRAIN_LM_STEPS steps without checkpoints (the timed
    run), then TRAIN_LM_RESUME_STEPS[0] steps with checkpoints under runs
    and resumed on the same --ckpt-dir to TRAIN_LM_RESUME_STEPS[1] (it
    must start at TRAIN_LM_RESUME_STEPS[0]) and 2 steps with --irc, these
    three at TRAIN_LM_SHORT's tokens, and musicgen-medium for
    TRAIN_LM_MUSICGEN_STEPS steps.  Returns each run's stats and
    launches."""
    import shutil
    from repro_torch.ckpt import latest_step
    first, then = TRAIN_LM_RESUME_STEPS
    ck = runs / "ckpt"
    hymba = ["--arch", "hymba-1.5b", *TRAIN_LM_FULL]
    short = ["--arch", "hymba-1.5b", *TRAIN_LM_SHORT]
    jobs = [("hymba", hymba + ["--steps", str(TRAIN_LM_STEPS),
                               "--ckpt-dir", ""]),
            ("hymba-resume-1", short + ["--steps", str(first),
                                        "--ckpt-dir", str(ck)]),
            ("hymba-resume-2", short + ["--steps", str(then),
                                        "--ckpt-dir", str(ck)]),
            ("hymba-irc", short + ["--steps", str(TRAIN_LM_IRC_STEPS),
                                   "--irc", "--ckpt-dir", ""]),
            ("musicgen", ["--arch", "musicgen-medium", *TRAIN_LM_FULL,
                          "--steps", str(TRAIN_LM_MUSICGEN_STEPS),
                          "--ckpt-dir", ""])]
    out = {}
    try:
        for tag, argv in jobs:
            st = _train_cli(argv, runs, tag, env)
            for line in st["lines"]:
                log("train_lm", f"train {tag}: {line}")
            log("train_lm", f"train {tag}: process {st['process_s']:.1f}s, "
                f"run dir {st['files']}, events {sorted(set(st['kinds']))}, "
                f"kernel launches {st['launches']}")
            st["line"] = log_train_stats(tag, st, card)
            out[tag] = st
            if tag == "hymba-resume-2":
                latest = latest_step(ck)
                saved = {p.name: sum(f.stat().st_size for f in (
                    p.rglob("*") if p.is_dir() else [p]) if f.is_file())
                         for p in sorted(ck.iterdir())}
                log("train_lm", f"checkpoints under the run's temporary "
                    f"directory: {saved} bytes, latest step {latest}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    a, b = out["hymba-resume-1"], out["hymba-resume-2"]
    check(a["resumed_at"] == 0 and a["steps"] == first
          and b["resumed_at"] == first and b["steps"] == then - first
          and f"(resumed at {first})" in b["last"] and latest == then,
          f"resume: {a['resumed_at']}/{a['steps']}, {b['resumed_at']}/"
          f"{b['steps']}, {b['last']}, latest {latest}")
    for tag, st in out.items():
        hybrid = tag.startswith("hymba")
        check(st["launches"]["threefry"] > 0
              and (st["launches"]["xla_fma"] > 0) == hybrid
              and not {k for k, v in st["launches"].items()
                       if v and k not in ("threefry", "xla_fma")},
              f"train {tag}: launches {st['launches']}")
        want = {"train_step", "phase"}
        if tag.startswith("hymba-resume"):
            want.add("checkpoint")
        check(want <= set(st["kinds"]), f"train {tag}: events {st['kinds']}")
    return out


def train_kernel_group(name: str) -> str:
    """A profiler row's group: matmul (cuBLAS / CUTLASS kernels), xla_fma
    (the scan's fused multiply-add, recorded under its autograd
    function), softmax, copy (copies and concatenations) or elementwise
    (the rest)."""
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "sm90_",
                              "xmma", "cublas")):
        return "matmul"
    if name == "_Fma" or "fma_kernel" in low:
        return "xla_fma"
    if "softmax" in low:
        return "softmax"
    if "copy" in low or "catarray" in low:
        return "copy"
    return "elementwise"


def train_lm_remat(ops_, card):
    """Step 4, a measurement: hymba-1.5b full (`init_train_state` on the
    card) at TRAIN_LM_REMAT_SHAPE under each remat mode: the peak of one
    value_and_grad and of one whole `make_train_step` above the memory
    held before it (state and batch), and the loss, equal across modes;
    then one micro-slice of the full run (TRAIN_LM_PROFILE_SHAPE, "block")
    timed and broken down by kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.models.common import scalar
    from repro_torch.models.transformer import LM
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         value_and_grad)
    torch.cuda.empty_cache()
    cfg = get_config("hymba-1.5b", "full")
    lm = LM(cfg)
    state = init_train_state(lm, prng.PRNGKey(0, device="cuda"),
                             device="cuda")
    lr = scalar(TRAIN_LM_LR, torch.float32, torch.device("cuda"))
    rows, seq = TRAIN_LM_REMAT_SHAPE
    batch = SyntheticLMData(cfg.vocab_size, seq, rows).batch_for_step(0)
    out = {}
    for mode in TRAIN_LM_REMAT:
        rec = {}
        for what in ("value_and_grad", "step"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                if what == "step":
                    res = make_train_step(lm, remat=mode,
                                          lr_fn=lambda s: lr)(state, batch)
                    loss = res[1]["loss"]
                else:
                    res = value_and_grad(lm, state.params, batch,
                                         remat=mode)
                    loss = res[0]
                loss = float(loss)
                torch.cuda.synchronize()
                rec[what] = {
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "above_gib": (torch.cuda.max_memory_allocated() - base)
                    / 2**30, "s": time.perf_counter() - t0, "loss": loss}
            except torch.cuda.OutOfMemoryError as e:
                rec[what] = {"oom": str(e).splitlines()[0][:120]}
            res = None
            torch.cuda.empty_cache()
        out[mode] = rec
        log("train_lm", f"remat {mode}, hymba-1.5b full at batch {rows} x "
            f"{seq}: {json.dumps(rec)}; {card}")
    losses = {m: r["step"]["loss"] for m, r in out.items()
              if "loss" in r.get("step", {})}
    check("block" in losses and all(
        abs(v - losses["block"]) <= TRAIN_LM_RTOL * abs(losses["block"])
        for v in losses.values()), f"remat losses differ: {losses}")
    log("train_lm", f"remat losses {losses} (bit-identical "
        f"{len(set(losses.values())) == 1})")
    rows, seq = TRAIN_LM_PROFILE_SHAPE
    batch = SyntheticLMData(cfg.vocab_size, seq, rows).batch_for_step(0)
    value_and_grad(lm, state.params, batch, remat="block")
    torch.cuda.synchronize()
    ops_.reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value_and_grad(lm, state.params, batch, remat="block")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows_ = sorted((e for e in prof.key_averages()
                    if not e.key.startswith("aten::") and dev_us(e) > 0),
                   key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows_) / 1e3
    launches = sum(e.count for e in rows_)
    groups = {}
    for e in rows_:
        g = train_kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + dev_us(e) / 1e3
    log("train_lm", f"hymba-1.5b full, one micro-slice ({rows} x {seq}, "
        f"remat block, value_and_grad) under the profiler: wall "
        f"{wall_ms:.1f} ms, kernels {busy_ms:.1f} ms in {launches} launches "
        f"(card idle {1 - busy_ms / wall_ms:.4f}), xla_fma launches "
        f"{ops_.LAUNCHES['xla_fma']}; ms by group "
        f"{ {g: round(v, 1) for g, v in sorted(groups.items())} }; {card}")
    for e in rows_[:12]:
        log("train_lm", f"  {dev_us(e) / 1e3:9.2f} ms x{e.count:<6d} "
            f"{e.key[:90]}")
    del state, batch
    torch.cuda.empty_cache()
    return {"remat": out, "profile": {
        "wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches,
        "groups": groups,
        "top": [(e.key[:90], dev_us(e) / 1e3, e.count) for e in rows_[:12]]}}


def train_lm_examples(ops_, runs, card):
    """Step 5: the examples in this process at their defaults, with
    `train_lm` at TRAIN_LM_EXAMPLE and a fresh --ckpt-dir: finite losses,
    the `# train stats` line; `serve_lm`: every request's tokens, all in
    the vocabulary.  Returns their launches."""
    import torch
    from repro_torch.examples import serve_lm, train_lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops_.reset_launches()
    res = train_lm.main([*TRAIN_LM_EXAMPLE, "--ckpt-dir",
                         str(runs / "example-ckpt")])
    launches = {"train_lm": dict(ops_.LAUNCHES)}
    hist, timer = res["history"], res["trainer"].step_timer
    losses = [h["loss"] for h in hist]
    tokens = 8 * 256
    st = {"arch": res["cfg"].name, "params": res["params"],
          "tokens_per_step": tokens, "steps": len(hist),
          "resumed_at": hist[0]["step"], "losses": losses,
          "step_times_s": [h["step_time_s"] for h in hist],
          "compile_s": timer.compile_s, "steps_per_sec": timer.rate(),
          "tokens_per_sec": timer.rate() * tokens,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    check(len(hist) == 50 and all(math.isfinite(x) for x in losses)
          and launches["train_lm"]["threefry"] > 0,
          f"train_lm example: {losses}, {launches}")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    log("train_lm", f"examples.train_lm {' '.join(TRAIN_LM_EXAMPLE)}: loss "
        f"first10 {first:.4f} last10 {last:.4f}; launches "
        f"{launches['train_lm']}")
    log_train_stats("example-train_lm", st, card)
    ops_.reset_launches()
    t0 = time.perf_counter()
    results = serve_lm.main([])
    wall = time.perf_counter() - t0
    launches["serve_lm"] = dict(ops_.LAUNCHES)
    new = sum(len(r.tokens) for r in results)
    check(len(results) == 6 and all(len(r.tokens) == 16 for r in results)
          and launches["serve_lm"]["threefry"] > 0,
          f"serve_lm example: {[len(r.tokens) for r in results]}")
    log("train_lm", f"examples.serve_lm (defaults): {len(results)} requests, "
        f"{new} tokens in {wall:.2f}s; launches {launches['serve_lm']}; "
        f"{card}")
    return launches


def phase_train_lm(ops_):
    """Phase `train_lm` (`--only train_lm` runs it alone): LM training on
    the card, TF32 checked off first: `train_lm_smoke`, `train_lm_wide`,
    `train_lm_scan_fma`, the CLI runs of `train_lm_cli`, the measurements
    of `train_lm_remat` and the examples of `train_lm_examples`.  Returns
    the launches of threefry and xla_fma on the training paths (the CLI
    runs' and the examples', each counted from 0 by its run) and each
    run's stats."""
    import shutil
    import tempfile
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the float32 legs would not be true float32")
    card = gpu_name_and_limit()
    log("train_lm", f"TF32 off (matmul and cuDNN); {card}")
    t0 = time.perf_counter()
    train_lm_smoke(ops_)
    train_lm_wide()
    train_lm_scan_fma()
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    runs = Path(tempfile.mkdtemp(prefix="chip_smoke_train_lm_"))
    try:
        cli = train_lm_cli(runs, env, card)
        measured = train_lm_remat(ops_, card)
        examples = train_lm_examples(ops_, runs, card)
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    by_path = {tag: {k: st["launches"][k] for k in ("threefry", "xla_fma")}
               for tag, st in cli.items()}
    by_path.update({f"example {k}": {n: v[n] for n in ("threefry",
                                                       "xla_fma")}
                    for k, v in examples.items()})
    log("train_lm", f"launches on the LM training paths {by_path}; "
        f"{time.perf_counter() - t0:.1f}s")
    return {"threefry": sum(v["threefry"] for v in by_path.values()),
            "xla_fma": sum(v["xla_fma"] for v in by_path.values()),
            "by_path": by_path,
            "stats": {tag: st["line"] for tag, st in cli.items()},
            **measured}


# phase `dryrun`: the reference's two dry-run test cells, traced at full
# width as cost probes on the fake 256-rank mesh and priced for the card
DRYRUN_CELLS = (("phi3-medium-14b", "train_4k"),
                ("qwen3-moe-235b-a22b", "decode_32k"))
# the smoke configs run one train step on a real 1x1 NCCL mesh
MESH_STEP_ARCHS = ("hymba-1.5b", "qwen3-moe-235b-a22b")


def dryrun_cells(card):
    """Step 1 of phase `dryrun`: each of DRYRUN_CELLS's cost probes
    (L1/L2, and x mb1/mb2 for train) at full width on the fake 256-rank
    "cuda" mesh, the roofline row they give (`perf.run_variant`, priced
    for the H100), and the FLOP inflation of the L1 probe (sum over the
    devices against the same step counted on one device)."""
    from repro_torch.launch import dryrun, perf
    rows = {}
    for arch, shape in DRYRUN_CELLS:
        row = perf.run_variant(arch, shape, "smoke-phase", {}, device="cuda")
        l1 = dryrun.probe_pair(arch)[0]
        p1 = row["probes"][f"L{l1}mb1"]
        check(p1["devices"] == 256 and p1["device_type"] == "cuda",
              f"dryrun {arch} {shape}: not the 256-rank cuda mesh: {p1}")
        one = dryrun.unsharded_flops(arch, shape, "full", probe_layers=l1,
                                     attn_mode=p1["attn_mode"],
                                     moe_groups=p1["moe_groups"],
                                     device="cuda")
        infl = p1["cost_analysis"]["flops"] * p1["devices"] / one
        check(0.99 <= infl <= 1.25 and row["flops_dev"] > 0,
              f"dryrun {arch} {shape}: FLOP inflation {infl}")
        row["inflation"] = infl
        coll = {k: v / 1e9 for k, v in row["coll_breakdown"].items() if v}
        log("dryrun", f"{arch} {shape} ({p1['attn_mode']}, microbatch "
            f"{max(1, p1['global_batch'] // 32) if p1['kind'] == 'train' else 1}"
            f", {row['method']}): per device args "
            f"{row['args_dev'] / 1e9:.4f} GB, temp (probe L{l1 + 1} mb1) "
            f"{row['memory_analysis_probe']['temp_size_in_bytes'] / 1e9:.3f}"
            f" GB, FLOPs {row['flops_dev']:.4e}, collectives GB {coll}; "
            f"compute {row['compute_s']:.4f} s, memory "
            f"{row['memory_s']:.4f} s, collective "
            f"{row['collective_s']:.4f} s ({row['dominant']}), useful "
            f"{row['useful_ratio']:.3f}; trace {row['lower_s']:.1f} s; "
            f"inflation {infl:.4f}; {card}")
        rows[f"{arch} {shape}"] = {k: row[k] for k in (
            "flops_dev", "bytes_dev", "coll_dev", "coll_breakdown",
            "args_dev", "compute_s", "memory_s", "collective_s",
            "dominant", "useful_ratio", "lower_s", "inflation")}
    return rows


def dryrun_smoke_meshes():
    """Step 2 of phase `dryrun`: every arch's smoke config traced for one
    cell (decode_32k) on both fake meshes."""
    from repro_torch.configs.registry import list_archs
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    seen = {}
    for mesh in ("single", "multi"):
        for arch in list_archs():
            rec = dryrun.lower_cell(arch, "decode_32k", mesh, "smoke",
                                    device="cuda")
            check(rec["status"] == "ok"
                  and rec["devices"] == (512 if mesh == "multi" else 256)
                  and rec["cost_analysis"]["flops"] > 0,
                  f"dryrun smoke {arch} {mesh}: {rec}")
            seen[f"{arch} {mesh}"] = rec["lower_s"]
    log("dryrun", f"every arch's smoke config, decode_32k on both meshes: "
        f"{len(seen)} records ok in {time.perf_counter() - t0:.1f}s")
    return seen


def mesh_step_worker() -> int:
    """`--mesh-step-worker` (a subprocess of phase `dryrun`, apart from the
    fake group): one train step of each MESH_STEP_ARCHS smoke config with
    and without `use_mesh` on a real 1x1 ("data","model") NCCL mesh of
    this card, from the same state; prints one JSON line: the two losses'
    bits, whether the logits are bit-identical, and the xla_fma launches
    of each step."""
    import tempfile
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import rules
    from repro_torch.train import steps
    dev = torch.device("cuda:0")
    store = tempfile.NamedTemporaryFile(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", store=dist.FileStore(store.name, 1),
                            rank=0, world_size=1, device_id=dev)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch in MESH_STEP_ARCHS:
            cfg = get_config(arch, "smoke")
            lm_p, lm_m = LM(cfg), LM(cfg).use_mesh(mesh)
            state = steps.init_train_state(lm_p, prng.PRNGKey(0, device=dev),
                                           device=dev)
            batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4).batch_for_step(
                                        0, device=dev)
            state_m = rules.tree_distribute(steps.train_state_axes(lm_m),
                                            state, mesh)
            batch_m = {k: rules.distribute(v, rules.batch_pspec(mesh), mesh)
                       for k, v in batch.items()}
            res = {}
            for tag, lm, st, b in (("plain", lm_p, state, batch),
                                   ("mesh", lm_m, state_m, batch_m)):
                ops.reset_launches()
                _, met = steps.make_train_step(lm)(st, b)
                loss = met["loss"]
                loss = loss.to_local() if hasattr(loss, "to_local") else loss
                torch.cuda.synchronize()
                res[tag] = {"loss": float(loss),
                            "bits": int(loss.view(torch.int32).item()),
                            "xla_fma": ops.LAUNCHES["xla_fma"]}
                with torch.no_grad():
                    logits = lm.apply(st.params, b["tokens"])[0]
                res[tag]["logits"] = (logits.to_local()
                                      if hasattr(logits, "to_local")
                                      else logits)
            same_logits = torch.equal(res["plain"].pop("logits"),
                                      res["mesh"].pop("logits"))
            out[arch] = {**res, "logits_bit_identical": same_logits,
                         "attn_mode": lm_m.attn_mode}
    finally:
        dist.destroy_process_group()
        store.close()
    print(json.dumps(out))
    return 0


def dryrun_mesh_step(card):
    """Step 3 of phase `dryrun`: `mesh_step_worker` in a subprocess; the
    loss under `use_mesh` must equal the plain step's bit for bit, and the
    xla_fma launches must be equal (hymba's SSM scan launches the kernel
    through the custom op on the DTensor's local shard)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--mesh-step-worker"], capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"mesh step worker failed: {r.stderr[-3000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for arch, res in out.items():
        p, m = res["plain"], res["mesh"]
        check(p["bits"] == m["bits"],
              f"{arch}: the loss on the 1x1 NCCL mesh {m['loss']!r} differs "
              f"from the plain step's {p['loss']!r}; logits bit-identical: "
              f"{res['logits_bit_identical']} (if so, the op that differs "
              f"is the cross-entropy's; if not, the forward's)")
        check(p["xla_fma"] == m["xla_fma"]
              and (p["xla_fma"] > 0) == (arch == "hymba-1.5b"),
              f"{arch}: xla_fma launches plain {p['xla_fma']} mesh "
              f"{m['xla_fma']}")
    log("dryrun", "one train step on a real 1x1 NCCL mesh vs without: "
        + "; ".join(f"{a} ({r_['attn_mode']}) loss {r_['mesh']['loss']!r} "
                    f"bit-identical, logits bit-identical "
                    f"{r_['logits_bit_identical']}, xla_fma launches "
                    f"{r_['mesh']['xla_fma']} = {r_['plain']['xla_fma']}"
                    for a, r_ in out.items())
        + f"; {time.perf_counter() - t0:.1f}s; {card}")
    return out


def start_meshcheck():
    """Step 4 of phase `dryrun`, started first: `repro_torch.launch.
    meshcheck` (`LM.use_mesh` on a real 2x2 gloo mesh of four processes on
    the host's CPU, one torch thread each, against the one-process port)
    in a subprocess that sees no card; it runs beside steps 1-3."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in (os.environ.get("PYTHONPATH"),)
                                 if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.meshcheck"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, time.perf_counter()


def stop_meshcheck(started) -> None:
    """Ends `start_meshcheck`'s subprocess and its four ranks (one process
    group), if still running."""
    import signal
    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def dryrun_meshcheck(started, card):
    """Waits for `start_meshcheck`'s subprocess; any of its failures (a
    mode other than q_groups / kv_heads / kv_seq, a loss, gradient, first
    moment or decode step past the CPU test's tolerances) fails the
    phase.  Logs the modes it covered and the worst differences."""
    import torch
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        stop_meshcheck(started)
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1]) if lines else None
    check(proc.returncode == 0 and rec is not None and not rec["failures"],
          f"meshcheck on the 2x2 gloo mesh failed (rc {proc.returncode}): "
          f"{rec['failures'] if rec else err[-3000:]}")
    log("dryrun", "use_mesh on a real 2x2 gloo mesh (4 CPU processes) vs "
        "one process, the CPU test's tolerances: " + "; ".join(
            f"{a} ({r['mode']}, moe_groups {r['moe_groups']}) loss rel "
            f"{r['loss_rel']:.3g}, grads rel L2 {r['grad_rel_l2']:.3g}, "
            f"moments {r['moment_rel_l2']:.3g}, 10 decode steps on a "
            f"sequence-sharded cache {r['decode_rel']:.3g}"
            for a, r in rec["summary"].items())
        + f"; {time.perf_counter() - t0:.1f}s since its start; torch "
        f"{torch.__version__}; {card}")
    return rec["summary"]


def phase_dryrun():
    """Phase `dryrun` (`--only dryrun` runs it alone): the mesh and
    dry-run tooling on the card (`dryrun_cells`, `dryrun_smoke_meshes`,
    then `dryrun_mesh_step` in a subprocess), and beside them, from the
    phase's start, `start_meshcheck`'s real 2x2 gloo mesh on the host's
    CPU.  The fake process group is ended before the mesh-step subprocess
    starts."""
    from repro_torch.launch import mesh as mesh_mod
    card = gpu_name_and_limit()
    t0 = time.perf_counter()
    started = start_meshcheck()
    try:
        try:
            rows = dryrun_cells(card)
            smoke = dryrun_smoke_meshes()
        finally:
            mesh_mod.destroy()
        step = dryrun_mesh_step(card)
        gloo = dryrun_meshcheck(started, card)
    finally:
        stop_meshcheck(started)
    log("dryrun", f"phase dryrun {time.perf_counter() - t0:.1f}s")
    return {"rows": rows, "smoke": smoke, "mesh_step": step, "gloo": gloo}


# phase `analysis`: the static-analysis suite on the card, and the fake
# kernel ops against the real kernels
ANALYSIS_CHIPS = 4              # the full-width ensemble's chips, one chunk
ANALYSIS_IMAGES = 2
K1_PER_CHUNK = 14               # group convs of yolo_irc.proposed()


def analysis_cli(env, card):
    """Step (a) of phase `analysis`: `python -m repro_torch.analysis --json`
    in a subprocess at its defaults (all three passes over src/repro_torch,
    the contracts on fake CUDA tensors); exit 0 and zero findings.  Returns
    its per-pass seconds."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as d:
        out = Path(d) / "findings.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--json",
             str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0 and out.is_file(),
              f"repro_torch.analysis exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        doc = json.loads(out.read_text())
    timing = doc["timing_s"]
    check(doc["findings"] == [] and {"keys", "trace", "contracts"}
          <= set(timing), f"repro_torch.analysis: {doc}")
    log("analysis", f"python -m repro_torch.analysis: 0 findings, exit 0; "
        f"per pass {json.dumps(timing)} s, process {wall:.1f}s; {card}")
    return dict(timing, process=wall)


def _leaf_signature(tree):
    """(shape, dtype, device type) of every tensor leaf of `tree`."""
    import torch
    from torch.utils._pytree import tree_leaves
    return [(tuple(t.shape), str(t.dtype), t.device.type)
            for t in tree_leaves(tree) if torch.is_tensor(t)]


def _fake_vs_real(ops_, contract):
    """One contract on fake CUDA tensors and then for real on seeded ones
    (launches counted from 0 for the real run): each declared spec met,
    the real leaves finite and of the fake leaves' shapes, dtypes and
    device.  Returns (real output, real launches)."""
    import torch
    from torch.utils._pytree import tree_leaves
    fake, fake_err = contract.trace("cuda")
    ops_.reset_launches()
    real, real_err = contract.trace("cuda", fake=False)
    torch.cuda.synchronize()
    launches = dict(ops_.LAUNCHES)
    check(fake_err is None and real_err is None,
          f"{contract.name}: {fake_err} / {real_err}")
    check(_leaf_signature(fake) == _leaf_signature(real),
          f"{contract.name}: fake {_leaf_signature(fake)} != real "
          f"{_leaf_signature(real)}")
    check(all(torch.isfinite(t.float()).all() for t in tree_leaves(real)
              if torch.is_tensor(t)), f"{contract.name}: non-finite output")
    if contract.route == "kernel":
        check(launches["irc_mvm_chips"] > 0 and launches["threefry"] > 0,
              f"{contract.name}: kernel route launched {launches}")
    elif contract.route == "plain":
        check(launches["irc_mvm_chips"] == 0,
              f"{contract.name}: plain route launched K1: {launches}")
    return real, launches


def analysis_contracts(ops_):
    """Step (b): every detector/MC contract (arch yolo-irc) on fake CUDA
    tensors and for real at its own sizes (`_fake_vs_real`).  Returns the
    real runs' K1 and threefry launches by contract."""
    from repro_torch.analysis.registry import shape_contracts
    out = {}
    for c in shape_contracts():
        if c.arch != "yolo-irc":
            continue
        real, launches = _fake_vs_real(ops_, c)
        out[c.name] = {k: launches[k] for k in ("irc_mvm_chips", "threefry")}
        log("analysis", f"{c.name} ({c.route or 'routed by the table'}): "
            f"fake == real {_leaf_signature(real)[:1]}, launches "
            f"{out[c.name]}")
    return out


_RECORDED = ("irc_mvm_chips", "irc_mvm", "threefry_fold_in",
             "threefry_split", "threefry_draw")


def _meta(v):
    import torch
    if torch.is_tensor(v):
        return ("tensor", tuple(v.shape), v.dtype, v.device)
    return v


def _recording(ops_, calls):
    """Context: each wrapper of `_RECORDED` records its first call on plain
    tensors of each argument signature (tensors by shape, dtype and
    device) with its real output's signature; calls on fake tensors are
    not recorded."""
    import contextlib
    import torch

    @contextlib.contextmanager
    def ctx():
        orig = {n: getattr(ops_, n) for n in _RECORDED}

        def wrap(name, fn):
            def recorded(*args, **kwargs):
                out = fn(*args, **kwargs)
                tensors = [v for v in (*args, *kwargs.values())
                           if torch.is_tensor(v)]
                if not ops_._direct(*tensors):
                    return out
                meta = (tuple(map(_meta, args)),
                        tuple(sorted((k, _meta(v))
                                     for k, v in kwargs.items())))
                calls.setdefault((name, repr(meta)),
                                 (meta, _leaf_signature(out)))
                return out
            return recorded
        for n, fn in orig.items():
            setattr(ops_, n, wrap(n, fn))
        try:
            yield
        finally:
            for n, fn in orig.items():
                setattr(ops_, n, fn)
    return ctx()


def analysis_fake_ops(ops_, calls):
    """Step (d): each recorded call of a fake op's wrapper replayed on fake
    CUDA tensors of the recorded shapes: the fake output's signature must
    be the real kernel's."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    def rebuild(v):
        if isinstance(v, tuple) and v and v[0] == "tensor":
            return torch.empty(v[1], dtype=v[2], device=v[3])
        return v
    by_op = {}
    for (name, _), ((args, kwargs), real_sig) in calls.items():
        with FakeTensorMode():
            fake = getattr(ops_, name)(*map(rebuild, args),
                                       **{k: rebuild(v) for k, v in kwargs})
        check(_leaf_signature(fake) == real_sig,
              f"fake {name} {args}: {_leaf_signature(fake)} != {real_sig}")
        by_op[name] = by_op.get(name, 0) + 1
    check(set(by_op) == set(_RECORDED), f"fake ops replayed: {by_op}")
    return by_op


def analysis_full_width(ops_):
    """Steps (c) and (d): `yolo_irc.proposed()` at full width in ensemble
    mode through K1 (use_kernel=True) at ANALYSIS_CHIPS chips and
    ANALYSIS_IMAGES images, fake against real (K1_PER_CHUNK launches), and
    the single-chip layer path of its first block (K2), with every call of
    the five fake ops' wrappers recorded and replayed on fake tensors."""
    import torch
    from repro_torch import prng
    from repro_torch.analysis.registry import ShapeContract, _expect
    from repro_torch.configs import yolo_irc
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.kernels.ops import irc_mvm_from_mapped
    from repro_torch.mc.detector_mc import build_detector_ensemble
    from repro_torch.models.detector import IRCDetector
    det = IRCDetector(yolo_irc.proposed())
    gh, gw, ho = det.head_geometry()
    C, B = ANALYSIS_CHIPS, ANALYSIS_IMAGES
    held = {}

    def body(inp):
        params = det.init(inp.key(), device=inp.device)
        ens = build_detector_ensemble(inp.key(1), det, params, C,
                                      cfg=NonidealConfig.all())
        out = det.apply(params, inp.floats((B, *det.cfg.img_hw, 3)),
                        mode="ensemble", ensemble=ens,
                        cfg_ni=NonidealConfig.all(), use_kernel=True)
        if not inp.fake:
            held["params"] = params
        return out, _expect(out, inp, (C, B, gh, gw, ho), torch.float32,
                            f"proposed ensemble x{C},kernel")
    contract = ShapeContract(f"proposed ensemble x{C},kernel",
                             "src/repro_torch/models/detector.py", body,
                             "yolo-irc", "kernel")
    calls = {}
    t0 = time.perf_counter()
    with _recording(ops_, calls):
        real, launches = _fake_vs_real(ops_, contract)
        check(launches["irc_mvm_chips"] == K1_PER_CHUNK,
              f"full-width ensemble: K1 launched {launches}")
        name, _, _, cin, ch = next(iter(det.blocks()))
        mapped = det.group_mappings(held.pop("params")[name], max(cin, ch),
                                    ch)[0]
        xs = (torch.rand((2 * S0_ROWS_PER_IMAGE, mapped.fan_in),
                         device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5)) < 0.5).float()
        single = irc_mvm_from_mapped(prng.PRNGKey(3, "cuda"), xs, mapped,
                                     NonidealConfig.all(), det.spec)
        torch.cuda.synchronize()
    log("analysis", f"yolo_irc.proposed() {det.cfg.img_hw}, {C} chips x {B} "
        f"images, use_kernel=True: fake == real {_leaf_signature(real)}, "
        f"launches {launches}; K2 layer path {tuple(single.shape)}; "
        f"{time.perf_counter() - t0:.1f}s")
    by_op = analysis_fake_ops(ops_, calls)
    log("analysis", f"fake ops against the kernels' real outputs at the "
        f"main path's shapes: {by_op} argument signatures")
    return {"launches": launches, "fake_ops": by_op}


def phase_analysis(ops_):
    """Phase `analysis` (`--only analysis` runs it alone): the port's
    static-analysis suite on the card (`analysis_cli`), every detector/MC
    shape contract fake against real (`analysis_contracts`), the
    full-width proposed detector through K1 fake against real and the
    fake ops against the real kernels (`analysis_full_width`).  Nothing is
    caught: any failure fails the run.  Returns each step's seconds."""
    import torch
    card = gpu_name_and_limit()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    timing = analysis_cli(env, card)
    t1 = time.perf_counter()
    contracts = analysis_contracts(ops_)
    t2 = time.perf_counter()
    full = analysis_full_width(ops_)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    secs = {"cli": t1 - t0, "contracts": t2 - t1, "full_width": t3 - t2,
            "phase": t3 - t0}
    log("analysis", f"phase analysis {secs['phase']:.1f}s (cli "
        f"{secs['cli']:.1f}, contracts {secs['contracts']:.1f}, full width "
        f"{secs['full_width']:.1f}); {card}")
    return {"passes_s": timing, "seconds": secs, "contracts": contracts,
            **full}


PHASES = ("kernels", "times", "main", "train", "serve", "network",
          "autotune", "cli", "devices", "paper", "lm", "train_lm", "dryrun",
          "analysis")


def main(argv=None) -> int:
    """Run the phases (all by default); any failure propagates and exits
    non-zero.  `--only kernels,times` runs a subset while iterating; only a
    run of every phase prints the result lines."""
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma list of phases to run, of {PHASES}, plus "
                         "'profile' (device-time breakdown of one chunk of "
                         "each main path) and 'threefry' (the die-sampling "
                         "kernel's checks and times alone), never run by "
                         "default")
    ap.add_argument("--threefry-baseline", default="",
                    help="comma list of other builds of threefry.cu (the "
                         "same C interface, e.g. the parent commit's) that "
                         "phases 4 and `devices` time in turns with the "
                         "tree's")
    ap.add_argument("--mesh-step-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_step_worker:
        return mesh_step_worker()
    only = set(args.only.split(","))
    baselines = tuple(Path(p).resolve()
                      for p in args.threefry_baseline.split(",") if p)
    unknown = only - set(PHASES) - {"profile", "threefry"}
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

    from repro_torch.kernels import (build, flash_attention_cuda as flash,
                                     irc_mvm, ops, ternary_matmul, threefry,
                                     xla_math)
    mods = (irc_mvm, ternary_matmul, flash, xla_math, threefry)
    sources = tuple(m.SOURCE for m in mods) + baselines
    build.build(*sources)
    for src in sources:
        log("2 build", f"nvcc sm_90a build of {src.name}: "
            f"{build.BUILD_S[src.name]:.1f}s into {build.build_dir()}")
        for line in build.BUILD_LOG.get(src.name, "").splitlines():
            if "Function properties for" in line:
                log("2 build", "ptxas: " + line.split(" for ")[-1][:90])
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                log("2 build", "ptxas: " + line.strip())
    # the tensor-core kernels serialize every wgmma if ptxas spills or
    # cannot prove a warpgroup's wgmmas uniform (C7520); the die sampling
    # and the elementwise math keep every value in registers; K1 parks its
    # block currents in a local array by design (a stack frame), and no
    # instantiation of its row tiles may spill
    for src in (ternary_matmul.SOURCE, flash.SOURCE, threefry.SOURCE,
                xla_math.SOURCE, irc_mvm.SOURCE):
        text = build.BUILD_LOG.get(src.name, "")
        spills = ptxas_spills(text, stack=src == irc_mvm.SOURCE)
        check("C7520" not in text and not spills,
              f"{src.name}: ptxas serialized wgmma, spilled or kept a "
              f"stack frame: {spills}")
    for mod in mods:
        mod.load()

    checks, k4_err = {}, {}
    if "kernels" in only:
        checks = phase_kernels(ops)
        checks["ragged"] = (0.0, phase_k1_ragged(ops))
        phase_k3_checks(ops)
        k4_err = phase_k4_checks(ops)
        phase_xla_checks(ops)
        phase_xla_all_floats(ops)
        phase_threefry_checks(ops)
        phase_threefry_tails()
    times, k3_times, k4_times, xla_times, tf_times = {}, {}, {}, {}, {}
    if "times" in only:
        times = phase_times(ops)
        k3_times = phase_k3_times(ops)
        k4_times = phase_k4_times(ops)
        xla_times = phase_xla_times(ops)
        tf_times = phase_threefry_times(ops, baselines)
    launches, single, layer, k4_launches, baseline = {}, {}, {}, {}, {}
    main_maps = None
    if "main" in only:
        launches, single, main_maps = phase_main_path(ops)
        layer = phase_layer_path(ops)
        k4_launches = phase_k4_path(ops)
        baseline = phase_baseline_detector(ops)
    train = {}
    if "train" in only:
        train = phase_train(ops)
    serve = {}
    if "serve" in only:
        serve = phase_serve(ops)
    if "network" in only:
        phase_network(ops)
        phase_layer_network(ops)
    tuned = {}
    if "autotune" in only:
        tuned = phase_autotune(ops)
    if "cli" in only:
        phase_cli()
    devices = {}
    if "devices" in only:
        devices = phase_devices(ops, main_maps, baselines)
    paper = {}
    if "paper" in only:
        paper = phase_paper(ops)
    lm = {}
    if "lm" in only:
        lm = phase_lm(ops)
    train_lm = {}
    if "train_lm" in only:
        train_lm = phase_train_lm(ops)
    dry = {}
    if "dryrun" in only:
        dry = phase_dryrun()
    analysis = {}
    if "analysis" in only:
        analysis = phase_analysis(ops)
    if "threefry" in only:
        phase_threefry_checks(ops)
        phase_threefry_tails()
        phase_threefry_times(ops, baselines)
    if "profile" in only:
        phase_profile()
    if only != set(PHASES):
        log("8 summary", f"ran phases {sorted(only)} only; no result")
        return 1

    kernels = []
    qat = train["launches"]
    served = serve["launches"]

    def on_paper(name):
        """Launches of `name` on phase `paper`'s three drivers."""
        return sum(counts[name] for counts in paper.values())
    for name, replaces, n in (
            ("irc_mvm_chips", "src/repro/kernels/irc_mvm.py:228",
             launches["irc_mvm_chips"] + qat["irc_mvm_chips"]
             + served["irc_mvm_chips"] + on_paper("irc_mvm_chips")),
            ("irc_mvm", "src/repro/kernels/irc_mvm.py:184",
             single["irc_mvm"] + on_paper("irc_mvm"))):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/irc_mvm.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": max(t["max_abs_err"], train["k1"]["max_abs_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # K1's row tiles (phase `autotune`): each alone at the chunk problems,
    # the plain route there, and the tile the sweep chose per problem
    kernels[0]["tiles"] = [list(t) for t in irc_mvm.TILES]
    kernels[0]["layer_chunk"] = times["irc_mvm_chips layer"]
    kernels[0]["tile_ms"] = {k: v["ms"] for k, v in tuned["bare"].items()}
    kernels[0]["plain_route_ms"] = {k: v["plain_route_ms"]
                                    for k, v in tuned["bare"].items()}
    kernels[0]["chosen"] = {k: [r["bm"], r["tm"], r["use_kernel"]]
                            for k, r in tuned["measured"].items()}
    # K3 at the layer path's shape; its launches are the two layer runs'
    # and the paper drivers'
    t = k3_times["layer"]
    kernels.append({
        "name": "ternary_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/ternary_matmul.cu",
        "replaces": "src/repro/kernels/ternary_matmul.py:38",
        "launches": sum(c["ternary_matmul"] for c in layer.values())
        + on_paper("ternary_matmul"),
        "max_abs_err": max(v["max_abs_err"] for v in k3_times.values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # K4's two legs, each with its launches on the op path
    for name, dtype in (("flash_attention", "float32"),
                        ("flash_attention_bf16", "bfloat16")):
        t = k4_times[dtype]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:75",
            "launches": k4_launches[dtype], "max_abs_err": k4_err[dtype],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the elementwise kernels; their launches are the two detector runs',
    # the QAT path's and the paper drivers'
    for name, t in xla_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/xla_math.cu",
            "replaces": XLA_REPLACES[name],
            "launches": launches[name] + baseline[name] + qat[name]
            + on_paper(name) + train_lm.get(name, 0),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # the die sampling at the periphery draw; its launches are the two
    # detector runs', the QAT path's, the service's and the paper drivers'
    t = tf_times["normal"]
    kernels.append({
        "name": "threefry", "route": "cuda",
        "source": "src/repro_torch/csrc/threefry.cu",
        "replaces": "src/repro/core/nonideal.py:64",
        "launches": launches["threefry"] + baseline["threefry"]
        + qat["threefry"] + served["threefry"] + on_paper("threefry")
        + lm["threefry"] + train_lm["threefry"],
        "max_abs_err": max(v["max_abs_err"] for v in tf_times.values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # the measured tail at the layer mask shape; its launches are the aging
    # sweeps' (detector and layer)
    t = devices["times"]["mask"]
    kernels.append({
        "name": "threefry_measured", "route": "cuda",
        "source": "src/repro_torch/csrc/threefry.cu",
        "replaces": MEASURED_REPLACES, "launches": devices["launches"],
        "max_abs_err": max(v["max_abs_err"]
                           for v in devices["times"].values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log("8 summary", "threefry launches by path: detector proposed "
        f"{launches['threefry']}, detector baseline {baseline['threefry']}, "
        f"layer {dict((d, c['threefry']) for d, c in layer.items())}, "
        f"single-chip layer {single['threefry']}, QAT (quick_qat, "
        f"{TRAIN_STEPS} ensemble steps) {qat['threefry']}, service "
        f"({SERVE_REQUESTS} requests) {served['threefry']}, LM paths "
        f"(phase `lm`) {lm['threefry']}, LM training (phase `train_lm`) "
        f"{train_lm['threefry']}")
    log("8 summary", "the LM training paths (phase `train_lm`) run no "
        "port of a TPU kernel either: threefry at each init and xla_fma in "
        "the SSM scan's fused multiply-add, launched by path "
        f"{train_lm['by_path']}")
    log("8 summary", "the LM serving path (phase `lm`) runs no port of a "
        "TPU kernel: its device work is torch matmul / einsum, as the "
        "reference's is plain jnp; its only kernel is threefry, launched "
        f"by path {lm['by_path']}")
    log("8 summary", f"K1 launches by path: detector proposed "
        f"{launches['irc_mvm_chips']}, QAT {qat['irc_mvm_chips']}, service "
        f"{served['irc_mvm_chips']}; the auto-routed chunk of phase "
        f"`autotune` {tuned['auto_k1']}")
    log("8 summary", f"paper drivers' launches (phase `paper`): {paper}")
    log("8 summary", "the mesh and dry-run tooling (phase `dryrun`) runs "
        "no port of a TPU kernel: per-device roofline terms "
        + "; ".join(f"{cell}: compute {r['compute_s']:.4f} s, memory "
                    f"{r['memory_s']:.4f} s, collective "
                    f"{r['collective_s']:.4f} s"
                    for cell, r in dry["rows"].items()))
    log("8 summary", f"QAT path launches ({TRAIN_STEPS} ensemble steps of "
        f"quick_qat): {qat}; per step by configuration: "
        + "; ".join(f"{k}: {v['launches']}"
                    for k, v in train["steps"].items()))
    log("8 summary", "the static-analysis suite (phase `analysis`) runs no "
        "port of a TPU kernel: 0 findings from keys, trace and "
        f"contracts ({analysis['passes_s']['contracts']:.1f}s on fake CUDA "
        f"tensors), K1 "
        f"{analysis['launches']['irc_mvm_chips']} and threefry "
        f"{analysis['launches']['threefry']} launches in the full-width "
        f"fake-vs-real chunk, phase {analysis['seconds']['phase']:.1f}s")
    flips = sum(f for _, f in checks.values())
    log("8 summary", f"binary flips of K1/K2 in phase 3: {flips}; total "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
