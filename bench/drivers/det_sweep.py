"""Driver of the detector's Table II sweep: the program's
`mc/detector_mc.py::run_mc_detector` (pipelined), called back to back on
fresh die populations, call i keyed fold_in(PRNGKey(seed), i), each call
`chunks_per_call` chunks of `chunk` dies over one eval batch of rendered
scenes.  A die counts when its chunk's mAP@0.5 was scored inside the
window.

Set-up: latent weights on the card from the seed (objectness biases at
the configuration's prior), the eval batch rendered from the seed, the
stem's BN calibrated on it by the program, and one warm-up call of one
chunk at the window's shapes.

Check: the head outputs of `sample_dies` dies drawn from the seed among
the first `sample_calls` calls, as the program scored them (a copy taken
on their way into the program's scoring), against the plain reference's
on the same weights, scenes and keys (`head_mismatch`: the share of
elements more than `head_tol` apart); and each sampled die's mAP@0.5 as
the program reported it against the reference's scoring of the same head
outputs (`map_gap`, exact: the scoring is the same arithmetic).  At
random weights with the objectness prior no box passes the threshold and
every die's mAP is 0, so `map_gap` sees a score altered where it is
produced, not scoring that was skipped or cut short.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchkit import inputs, judge, registry, sweeps


def make_inputs(ctx) -> Dict[str, Any]:
    """The benchmark's own inputs, from the seed: weights and the eval
    batch with its ground truth."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    weights = inputs.detector_weights(cfg, ctx.seed, dev)
    images_np, boxes, classes = inputs.render_scenes(
        tuple(cfg["img_hw"]), tr["images"], cfg["n_classes"], (ctx.seed, 1))
    return {"ctx": ctx, "weights": weights,
            "images": torch.from_numpy(images_np).to(dev),
            "boxes": boxes, "classes": classes}


def setup(ctx) -> Dict[str, Any]:
    from repro_torch.mc.detector_mc import run_mc_detector
    from repro_torch.mc.engine import McConfig

    tr, dev = ctx.traffic, ctx.device
    sweeps.threefry_scheme(ctx.config)
    state = make_inputs(ctx)
    det = sweeps.detector(ctx.config)
    params = sweeps.detector_params(det, state["weights"], state["images"])
    mc = McConfig(n_chips=tr["chunk"] * tr["chunks_per_call"],
                  chunk_size=tr["chunk"], cfg=sweeps.effects(tr["effects"]),
                  device=sweeps.device_model(tr.get("device")))
    state.update(det=det, params=params, mc=mc, run=run_mc_detector,
                 use_kernel=tr.get("use_kernel"))
    run_mc_detector(sweeps.call_key(ctx.seed, sweeps.WARM_CALL, dev), det,
                    params, state["images"], state["boxes"], state["classes"],
                    mc=dataclasses.replace(mc, n_chips=tr["chunk"]),
                    pipeline=True, use_kernel=state["use_kernel"])
    return state


def _sample(ctx) -> List[Tuple[int, int]]:
    """(call, die) pairs to check, drawn from the seed: one die of the
    first call, which every window runs, and the rest among the first
    `sample_calls` calls."""
    tr = ctx.traffic
    per_call = tr["chunk"] * tr["chunks_per_call"]
    rng = np.random.default_rng((ctx.seed, 2))
    first = int(rng.integers(per_call))
    rest = rng.choice(np.delete(np.arange(tr["sample_calls"] * per_call),
                                first),
                      size=tr["sample_dies"] - 1, replace=False)
    return sorted((int(p) // per_call, int(p) % per_call)
                  for p in [first, *rest])


def window(state: Dict[str, Any], seconds: float) -> Dict[str, Any]:
    import repro_torch.train.det_loss as det_loss
    from torch.autograd.profiler import record_function

    ctx, tr = state["ctx"], state["ctx"].traffic
    score = det_loss.evaluate_map_per_chip
    chunk = tr["chunk"]
    captured: Dict[Tuple[int, int], np.ndarray] = {}
    # every die of the first `sample_calls` calls is a candidate; only the
    # sampled ones are kept once the window is over
    sampled = set(_sample(ctx))
    where = {"call": 0, "chunk": 0}

    def scored(preds, *args, **kwargs):
        call, lo = where["call"], where["chunk"] * chunk
        for i in range(np.shape(preds)[0]):
            if (call, lo + i) in sampled:
                captured[(call, lo + i)] = np.array(preds[i])
        where["chunk"] += 1
        with record_function("bench.score"):
            return score(preds, *args, **kwargs)

    def one_call(i: int, clock):
        where.update(call=i, chunk=0)
        with record_function("bench.run_mc_detector"):
            return state["run"](
                sweeps.call_key(ctx.seed, i, ctx.device), state["det"],
                state["params"], state["images"], state["boxes"],
                state["classes"], mc=state["mc"], obs=clock, pipeline=True,
                use_kernel=state["use_kernel"])

    det_loss.evaluate_map_per_chip = scored
    try:
        w = sweeps.run_window(seconds, one_call)
    finally:
        det_loss.evaluate_map_per_chip = score
    res = w["calls"]
    state["captured"] = captured
    state["n_calls"] = len(res)
    return {"metrics": {"det_dies_per_s": w["dies_in_window"] / seconds},
            "attempted": w["dies_in_window"], "failed": 0,
            "raw": {"dies": w["dies_total"], "traced_s": w["traced_s"],
                    "images": tr["images"], "chunk": chunk,
                    "enqueue_s": sum(r.enqueue_s for r in res),
                    "host_s": sum(r.host_s for r in res)},
            "per_chip": [r.per_chip["map50"] for r in res]}


def check(state: Dict[str, Any], result: Dict[str, Any]
          ) -> List[Tuple[str, float, float]]:
    ctx, tr, cfg = state["ctx"], state["ctx"].traffic, state["ctx"].config
    limits = tr["limits"]
    picks = [p for p in _sample(ctx) if p[0] < state["n_calls"]]
    captured = state.pop("captured")
    ref, effects, device = sweeps.hand_over(
        state, ("det", "params", "mc", "run"))
    prog, want, gaps = [], [], []
    for call, die in picks:
        r = ref.heads(state["weights"], cfg, state["images"],
                      sweeps.call_key(ctx.seed, call, ctx.device), [die],
                      effects=effects, device=device)[0].cpu().numpy()
        p = captured.get((call, die))
        ok = p is not None and p.shape == r.shape
        prog.append(p if ok else np.full_like(r, np.nan))
        want.append(r)
        reported = np.float32(result["per_chip"][call][die])
        gaps.append(abs(float(reported) - float(np.float32(ref.score(
            p, state["boxes"], state["classes"], cfg)))) if ok
            else float("inf"))
    return [("head_mismatch",
             judge.mismatch_share(np.stack(prog), np.stack(want),
                                  limits["head_tol"]),
             limits["head_mismatch"]),
            ("map_gap", max(gaps), limits["map_gap"])]


def control(state: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """The reference at `precision` in the program's place: fills
    `state` and returns the window record that `check` reads, for the
    dies that a window's check samples."""
    from reference import irc

    ctx, tr, cfg = state["ctx"], state["ctx"].traffic, state["ctx"].config
    ref = registry.load_reference(ctx.config_name)
    picks = _sample(ctx)
    captured, per_chip = {}, {}
    for call, die in picks:
        p = ref.heads(state["weights"], cfg, state["images"],
                      sweeps.call_key(ctx.seed, call, ctx.device), [die],
                      effects=irc.Effects(**tr["effects"]),
                      device=irc.Device.from_traffic(tr.get("device")),
                      precision=precision)[0].cpu().numpy()
        captured[(call, die)] = p
        per_chip.setdefault(call, {})[die] = ref.score(
            p, state["boxes"], state["classes"], cfg)
    state.update(captured=captured, n_calls=tr["sample_calls"])
    return {"per_chip": per_chip}
