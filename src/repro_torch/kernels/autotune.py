"""Row-tile autotuner of the chip-batched IRC MVM kernel (K1), and the
table behind the detector's `use_kernel=None` routing.

The counterpart of the JAX package's `repro.kernels.autotune`.  There the
Pallas kernel is tiled by (bm, bn, bk); here K1's tunable is its row tile
`(bm, tm)`: bm word-line rows a thread block, tm of them a thread
(`kernels/irc_mvm.py::TILES`).  `sweep()` times every candidate tile
against the plain batched route (`mc.engine.ensemble_apply`, the code the
detector takes when the kernel does not win) with CUDA events and commits
the results to `tuning.json` beside this module, the port's own table.

The dispatch side is two lookups against that table:

  kernel_wins(C, M, N, K)   False iff an entry for this card and problem
                            says the plain route beat K1
  best_blocks(C, M, N, K)   the winning (bm, tm), or DEFAULT_BLOCKS

Keys are `cuda/<card>/c{C}_m{M}_n{N}_k{K}` on the card, `<card>` the slug
of `torch.cuda.get_device_name()` (`card_slug`), so a table measured on one
card never routes another, and `cpu/c{C}_m{M}_n{N}_k{K}` on the CPU.

An absent entry routes to K1 at DEFAULT_BLOCKS, where the reference keeps
an untuned problem on its plain path.  This is deliberate: the port's main
path on the card runs its hand-written kernel unless a measurement on that
card says otherwise, and on the CPU "K1" is its plain version
(`ops.irc_mvm_chips`), so nothing changes route until a sweep is
committed.  The sweep needs a card; the table holds no `cpu/` entries.

Re-run the sweep on the card (it writes only the port's table, never the
JAX package's `repro/kernels/tuning.json`):

  PYTHONPATH=src python -m repro_torch.kernels.autotune --config proposed \\
      --chips 4 --batch 2 --write        # a sweep chunk: 4 chips x 2 images
  PYTHONPATH=src python -m repro_torch.kernels.autotune --config proposed \\
      --chips 4 --batch 1 --write        # the service's waves: 1 image
  PYTHONPATH=src python -m repro_torch.kernels.autotune --network layer \\
      --chips 4096 --batch 256 --write   # the macro layer's chunk

A layer problem (`layer_problems`) has one batch of word lines shared by
every chip; a detector problem has word lines per chip.
"""
from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.irc_mvm import DEFAULT_TILE, TILES, check_tile

TUNING_JSON = Path(__file__).resolve().parent / "tuning.json"

DEFAULT_BLOCKS: Tuple[int, int] = DEFAULT_TILE
DEFAULT_CANDIDATES: Tuple[Tuple[int, int], ...] = TILES


def card_slug(name: str) -> str:
    """A card's name as a table key part: "NVIDIA H100 80GB HBM3" ->
    "nvidia-h100-80gb-hbm3"."""
    return re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")


@functools.lru_cache(maxsize=None)
def _cuda_backend(index: int) -> str:
    return f"cuda/{card_slug(torch.cuda.get_device_name(index))}"


def backend_of(device=None) -> str:
    """The table's backend for a torch device: "cuda/<card slug>" for a
    CUDA device, "cpu" for the CPU.  None: the current CUDA device when a
    card is visible, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return _cuda_backend(device.index if device.index is not None
                         else torch.cuda.current_device())


def problem_key(C: int, M: int, N: int, K: int,
                backend: Optional[str] = None) -> str:
    """The table key of one (chips, rows of x, columns, crossbar rows)
    problem on `backend` (None: `backend_of()`)."""
    backend = backend or backend_of()
    return f"{backend}/c{C}_m{M}_n{N}_k{K}"


@functools.lru_cache(maxsize=1)
def load_table() -> Dict[str, dict]:
    """The committed tuning table (cached; `sweep(write=True)` clears the
    cache)."""
    if not TUNING_JSON.exists():
        return {}
    try:
        return json.loads(TUNING_JSON.read_text())
    except json.JSONDecodeError:
        return {}


def lookup(C: int, M: int, N: int, K: int,
           backend: Optional[str] = None) -> Optional[dict]:
    """The table's entry for a problem on `backend`, or None."""
    return load_table().get(problem_key(C, M, N, K, backend))


def kernel_wins(C: int, M: int, N: int, K: int,
                backend: Optional[str] = None) -> bool:
    """The auto-dispatch rule: K1 unless a committed sweep on this card
    measured the plain route faster (absent entry: K1)."""
    entry = lookup(C, M, N, K, backend)
    return entry is None or bool(entry.get("use_kernel"))


def best_blocks(C: int, M: int, N: int, K: int,
                backend: Optional[str] = None) -> Tuple[int, int]:
    """K1's row tile (bm, tm) for a problem: the entry's, or
    DEFAULT_BLOCKS."""
    entry = lookup(C, M, N, K, backend)
    if entry:
        return (int(entry["bm"]), int(entry["tm"]))
    return DEFAULT_BLOCKS


# ------------------------------------------------------------------ sweeping

def _median_us(fn, reps: int = 3) -> float:
    """Device time of `fn()` on CUDA events: one warm-up call, then the
    median of `reps` calls, in microseconds."""
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
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def _problem(C: int, M: int, N: int, K: int, seed: int = 0,
             per_chip_x: bool = True):
    """A synthetic ensemble problem of the given geometry on the card,
    drawn as the reference's `_problem` draws it: K-row ternary-ish
    placement planes (no bias rows: K is the row count the kernel sees),
    word-line bits at density 0.5, and a C-chip sampled ensemble with
    every effect on.  The word lines are per chip, [C, M, K], the layout
    of every group conv of the detector past its first (13 of the proposed
    design's 14), where the reference times a shared [M, K] batch; with
    `per_chip_x=False` one [M, K] batch shared by every chip (the macro
    layer's)."""
    from repro_torch import prng
    from repro_torch.core import nonideal as ni
    from repro_torch.core.mapping import MappedLayer
    from repro_torch.mc.ensemble import sample_ensemble

    k0, k1, k2 = prng.split(prng.PRNGKey(seed, device="cuda"), 3)
    gp = (prng.uniform(k0, (K, N)) > 0.7).float()
    gn = (prng.uniform(k1, (K, N)) > 0.7).float() * (1 - gp)
    mapped = MappedLayer(g_pos=gp, g_neg=gn, bias_rows=0, scheme="ternary",
                         fan_in=K)
    x = (prng.uniform(k2, ((C,) if per_chip_x else ()) + (M, K))
         > 0.5).float()
    cfg = ni.NonidealConfig.all()
    ens = sample_ensemble(prng.PRNGKey(seed + 1, device="cuda"), mapped, C,
                          cfg=cfg)
    return ens, x, cfg


def autotune_problem(C: int, M: int, N: int, K: int, *,
                     candidates: Sequence[Tuple[int, int]]
                     = DEFAULT_CANDIDATES,
                     seed: int = 0, per_chip_x: bool = True
                     ) -> Tuple[dict, List[dict]]:
    """Time every candidate tile of K1 and the plain route on one problem
    on the card; returns (winner record, per-candidate roofline rows).

    Both routes are timed whole, from the ensemble and word lines to the
    binary outputs, periphery draws included: what the detector's routing
    chooses between.  FLOP accounting for the rows, the reference's: 4 MVM
    planes (e+/e- currents, g+/g- counts) at 2 M N K each, per chip."""
    if not torch.cuda.is_available():
        raise RuntimeError("the autotuner times K1 on the card and no CUDA "
                           "device is visible (on the CPU there is no "
                           "kernel to time)")
    from repro_torch.mc.engine import ensemble_apply, ensemble_apply_kernel

    ens, x, cfg = _problem(C, M, N, K, seed, per_chip_x)
    flops = 4 * 2.0 * C * M * N * K
    plain_us = _median_us(lambda: ensemble_apply(ens, x, cfg=cfg,
                                                 per_chip_x=per_chip_x))
    rows = [{"impl": "plain", "bm": 0, "tm": 0, "us": plain_us,
             "gflops": flops / plain_us * 1e-3}]
    best = None
    for tile in candidates:
        bm, tm = check_tile(tile)
        us = _median_us(lambda: ensemble_apply_kernel(
            ens, x, cfg=cfg, per_chip_x=per_chip_x, tile=(bm, tm)))
        rows.append({"impl": "kernel", "bm": bm, "tm": tm, "us": us,
                     "gflops": flops / us * 1e-3})
        if best is None or us < best["kernel_us"]:
            best = {"bm": bm, "tm": tm, "kernel_us": us}
    dev = x.device
    record = dict(best, plain_us=plain_us,
                  use_kernel=best["kernel_us"] < plain_us,
                  backend=backend_of(dev),
                  card=torch.cuda.get_device_name(dev),
                  candidates_us={f"{r['bm']}x{r['tm']}": r["us"]
                                 for r in rows[1:]})
    return record, rows


def sweep(problems: Sequence[Tuple[int, int, int, int]], *,
          candidates: Sequence[Tuple[int, int]] = DEFAULT_CANDIDATES,
          write: bool = False, path: Optional[Path] = None,
          per_chip_x: bool = True) -> Dict[str, dict]:
    """Autotune each (C, M, N, K) problem on the card (word lines per chip,
    or with `per_chip_x=False` shared); with `write`, merge the records
    into the table at `path` (None: the committed `TUNING_JSON`), keeping
    every other entry (other cards' too)."""
    target = Path(path) if path is not None else TUNING_JSON
    out: Dict[str, dict] = {}
    for C, M, N, K in problems:
        kw = {} if per_chip_x else {"per_chip_x": False}
        record, _ = autotune_problem(C, M, N, K, candidates=candidates, **kw)
        out[problem_key(C, M, N, K, record["backend"])] = record
    if write:
        table = {}
        if target.exists():
            table = json.loads(target.read_text())
        table.update(out)
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
        load_table.cache_clear()
    return out


def detector_problems(det_cfg, batch: int, chips: int
                      ) -> List[Tuple[int, int, int, int]]:
    """The distinct (C, M, N, K) kernel problems of one detector config:
    every group crossbar of layer s{s}b{b} shares N = group columns and
    K = bias_rows + 9*group rows; M = batch * H_s * W_s shrinks with the
    stage's pooling."""
    probs = set()
    H = det_cfg.img_hw[0] // 2
    W = det_cfg.img_hw[1] // 2
    K = det_cfg.bias_rows + 9 * det_cfg.group
    for s, nb in enumerate(det_cfg.blocks_per_stage):
        for _ in range(nb):
            probs.add((chips, batch * H * W, det_cfg.group, K))
        H, W = H // 2, W // 2
    return sorted(probs)


def layer_problems(n_out: int, rows: int, batch: int, chips: int
                   ) -> List[Tuple[int, int, int, int]]:
    """The macro layer's one kernel problem: `chips` dies of a `rows` x
    `n_out` crossbar on one batch of `batch` shared word lines."""
    return [(chips, batch, n_out, rows)]


def main(argv=None) -> None:
    """Sweep a detector config's problems (or the macro layer's) on the
    card and print the winners; `--write` merges them into the table."""
    ap = argparse.ArgumentParser(
        description="(bm, tm) row-tile sweep for K1 (irc_mvm_chips)")
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--network", default="detector",
                    choices=["detector", "layer"],
                    help="the detector's group convs (word lines per "
                         "chip) or the proposed macro layer, 540 inputs "
                         "+ 32 bias rows by 60 (shared word lines)")
    ap.add_argument("--config", default="smoke",
                    choices=["smoke", "proposed"],
                    help="yolo_irc.smoke('ternary') (the reference's "
                         "sweep) or the full-width yolo_irc.proposed()")
    ap.add_argument("--write", action="store_true",
                    help="merge the results into the committed table")
    args = ap.parse_args(argv)

    from repro_torch.configs import yolo_irc
    if args.network == "layer":
        cfg = yolo_irc.proposed()
        problems = layer_problems(cfg.group, cfg.bias_rows + 9 * cfg.group,
                                  args.batch, args.chips)
    else:
        cfg = (yolo_irc.proposed() if args.config == "proposed"
               else yolo_irc.smoke("ternary"))
        problems = detector_problems(cfg, args.batch, args.chips)
    print(f"# backend={backend_of()} network={args.network} "
          f"config={args.config} problems={problems}")
    results = sweep(problems, write=args.write,
                    per_chip_x=args.network != "layer")
    for key, rec in results.items():
        tiles = " ".join(f"{t}={us:.0f}us"
                         for t, us in rec["candidates_us"].items())
        print(f"{key}: bm={rec['bm']} tm={rec['tm']} "
              f"kernel={rec['kernel_us']:.0f}us "
              f"plain={rec['plain_us']:.0f}us "
              f"use_kernel={rec['use_kernel']} [{tiles}]")
    if args.write:
        print(f"# wrote {TUNING_JSON}")


if __name__ == "__main__":
    main()
