"""Driver of the detector service: the program's
`serve/detector.py::DetectorServeEngine` with its background scheduler,
each request one rendered scene answered by a committee of `committee`
dies, `slots` requests a wave.

Arrivals are open-loop Poisson at the mix's `rate` (requests/s) on one
schedule for every seed (drawn from the mix's `schedule_seed`, so that
every run offers the same load in the same bursts); the seed draws which
scene each request carries and keys its dies.  A request is timed from
when it was
due until its response, and one refused by the queue or unanswered a
minute after the window closed counts as failed, at `FAILED_S`.  Scenes
come from a pool of `pool` scenes rendered at set-up; the stem's BN is
calibrated on the first `calib` of them.

Set-up also serves one wave of each size, 4 down to 1, before the
scheduler starts, so every lane and wave shape is warm.

Check: the committees' head outputs of `sample_requests` answered
requests drawn from the seed, one at each slot of a wave (the engine keeps
each response's committee), against the plain reference's for the same
scene under fold_in(PRNGKey(seed), request id), dies 0..committee-1
(`head_mismatch`); and each response's detections and mean per-die top
score against the reference's scoring of that same committee
(`answer_gap`).  At random weights with the objectness prior no box
passes the threshold, so every answer is empty and `answer_gap` sees only
an answer altered where it is produced, not decoding that was skipped.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchkit import inputs, judge, registry, sweeps

#: latency recorded for a refused or unanswered request (s)
FAILED_S = 1000.0
#: request ids of the warm-up waves, apart from every window's
WARM_ID = 0x7FFF0000
#: seconds past the window's close that a due request may still take
GRACE_S = 60.0


def _arrivals(tr: Dict[str, Any], seed: int, rate: float, seconds: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Due offsets (s from the window's start) below `seconds`, the same
    for every seed, and the scene of each request, drawn from the seed."""
    n = int(rate * seconds * 2 + 64)
    gaps = np.random.default_rng((tr["schedule_seed"], 3)).exponential(
        1.0 / rate, size=n)
    t = np.cumsum(gaps)
    scenes = np.random.default_rng((seed, 3)).integers(tr["pool"], size=n)
    keep = t < seconds
    return t[keep], scenes[keep]


def make_inputs(ctx) -> Dict[str, Any]:
    """The benchmark's own inputs, from the seed: weights and the scene
    pool (host), its calibration slice on the device."""
    cfg, tr = ctx.config, ctx.traffic
    weights = inputs.detector_weights(cfg, ctx.seed, ctx.device)
    scenes, _, _ = inputs.render_scenes(tuple(cfg["img_hw"]), tr["pool"],
                                        cfg["n_classes"], (ctx.seed, 1))
    return {"ctx": ctx, "weights": weights, "scenes": scenes,
            "calib": torch.from_numpy(scenes[:tr["calib"]]).to(ctx.device),
            "rate": float(tr["rate"]), "rid0": 0}


def wave_log():
    """A run log for the engine that keeps its "serve_wave" events."""
    from repro_torch.obs.runlog import NullRunLog

    class WaveLog(NullRunLog):
        def __init__(self):
            super().__init__()
            self.waves: List[Dict[str, Any]] = []

        def log_event(self, kind: str, **fields) -> None:
            if kind == "serve_wave":
                self.waves.append(fields)

    return WaveLog()


def setup(ctx) -> Dict[str, Any]:
    from repro_torch.serve.detector import DetectorServeEngine

    tr = ctx.traffic
    sweeps.threefry_scheme(ctx.config)
    state = make_inputs(ctx)
    det = sweeps.detector(ctx.config)
    params = sweeps.detector_params(det, state["weights"], state["calib"])
    log = wave_log()
    engine = DetectorServeEngine(
        det, params, committee=tr["committee"], batch_slots=tr["slots"],
        max_queue=tr["max_queue"], cfg_ni=sweeps.effects(tr["effects"]),
        seed=ctx.seed, use_kernel=tr.get("use_kernel"),
        keep_committee=True, obs=log,
        device=sweeps.device_model(tr.get("device")))
    rid = WARM_ID
    for lanes in range(tr["slots"], 0, -1):
        engine.serve_batch([state["scenes"][i % tr["pool"]]
                            for i in range(rid, rid + lanes)])
        rid += lanes
    engine.start()
    state.update(engine=engine, log=log)
    return state


def window(state: Dict[str, Any], seconds: float) -> Dict[str, Any]:
    from repro_torch.serve.detector import ServeQueueFull

    ctx, tr = state["ctx"], state["ctx"].traffic
    engine, log = state["engine"], state["log"]
    due, scenes = _arrivals(tr, ctx.seed, state["rate"], seconds)
    rid0 = state["rid0"]
    log.waves.clear()
    submitted: Dict[int, float] = {}
    refused = 0
    late = []
    t0 = time.perf_counter()
    for i, (d, s) in enumerate(zip(due, scenes)):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        t_sub = time.perf_counter()
        late.append(t_sub - (t0 + d))
        try:
            engine.submit(state["scenes"][s], request_id=rid0 + i)
            submitted[rid0 + i] = t_sub
        except ServeQueueFull:
            refused += 1
    t_close = t0 + seconds
    lat, responses = [], {}
    backlog = 0
    for i, d in enumerate(due):
        rid = rid0 + i
        if rid not in submitted:
            lat.append(FAILED_S)
            continue
        left = t_close + GRACE_S - time.perf_counter()
        try:
            r = engine.result(rid, timeout=max(left, 0.0))
        except TimeoutError:
            lat.append(FAILED_S)
            continue
        done = submitted[rid] + r.queue_s
        if done > t_close:
            backlog += 1
        lat.append(done - (t0 + d))
        responses[rid] = r
    traced_s = time.perf_counter() - t0
    lat_a = np.asarray(lat, np.float64)
    failed = int((lat_a >= FAILED_S).sum())
    waves = [w for w in log.waves]
    state.update(responses=responses, due_scenes=dict(
        (rid0 + i, int(s)) for i, s in enumerate(scenes)))
    state["rid0"] = rid0 + len(due)
    return {"metrics": {"serve_p95_s": float(np.percentile(lat_a, 95))
                        if lat_a.size else FAILED_S},
            "attempted": int(lat_a.size), "failed": failed,
            "raw": {"requests": len(responses), "traced_s": traced_s,
                    "committee": tr["committee"],
                    "wave_wall_s": [w["wall_s"] for w in waves],
                    "wave_host_s": [w["host_s"] for w in waves],
                    "wave_requests": [w["requests"] for w in waves],
                    "p50_s": float(np.percentile(lat_a, 50))
                    if lat_a.size else FAILED_S,
                    "late_p95_s": float(np.percentile(late, 95))
                    if late else 0.0,
                    "refused": refused,
                    "answered_after_close": backlog}}


def _picks(ctx, waves: Dict[int, Optional[int]]) -> List[int]:
    """Request ids to check, drawn from the seed among those answered
    (`waves`: request id -> the wave that answered it, or None): one at
    each slot of a wave there was (a request's slot is its place among
    its wave's requests, which the queue hands out in order), from waves
    drawn at random, then any others, up to `sample_requests`."""
    rng = np.random.default_rng((ctx.seed, 2))
    n = min(ctx.traffic["sample_requests"], len(waves))
    by_wave: Dict[int, List[int]] = {}
    for rid, w in sorted(waves.items()):
        if w is not None:
            by_wave.setdefault(w, []).append(rid)
    at_slot: Dict[int, List[int]] = {}
    for rids in by_wave.values():
        for slot, rid in enumerate(rids):
            at_slot.setdefault(slot, []).append(rid)
    picks = [int(rng.choice(at_slot[slot])) for slot in sorted(at_slot)][:n]
    rest = sorted(set(waves) - set(picks))
    if len(picks) < n:
        picks += [int(r) for r in rng.choice(rest, size=n - len(picks),
                                             replace=False)]
    return sorted(picks)


def _top_score(ref, pred: np.ndarray, cfg) -> float:
    """One die's top decoded score above the threshold, or 0.0."""
    _, scores, _ = ref.detmap.decode_boxes(pred, cfg["n_anchors"],
                                           cfg["n_classes"])
    return float(scores.max()) if scores.size else 0.0


def check(state: Dict[str, Any], result: Dict[str, Any]
          ) -> List[Tuple[str, float, float]]:
    ctx, tr, cfg = state["ctx"], state["ctx"].traffic, state["ctx"].config
    limits = tr["limits"]
    if "engine" in state:
        state["engine"].stop()
    responses = state.pop("responses")
    ref, effects, device = sweeps.hand_over(state, ("engine", "log"))
    prog, want, gaps = [], [], []
    picks = _picks(ctx, {rid: getattr(r, "wave", None)
                         for rid, r in responses.items()})
    if not picks:
        return [("head_mismatch", 1.0, limits["head_mismatch"]),
                ("answer_gap", float("inf"), limits["answer_gap"])]
    for rid in picks:
        scene = torch.from_numpy(
            state["scenes"][state["due_scenes"][rid]][None]).to(ctx.device)
        r = ref.heads(state["weights"], cfg, scene,
                      sweeps.call_key(ctx.seed, rid, ctx.device),
                      list(range(tr["committee"])), effects=effects,
                      device=device, calib=state["calib"])[:, 0].cpu().numpy()
        resp = responses[rid]
        c = resp.committee
        ok = c is not None and c.shape == r.shape
        prog.append(c if ok else np.full_like(r, np.nan))
        want.append(r)
        gaps.append(_answer_gap(ref, resp, cfg) if ok else float("inf"))
    return [("head_mismatch",
             judge.mismatch_share(np.stack(prog), np.stack(want),
                                  limits["head_tol"]),
             limits["head_mismatch"]),
            ("answer_gap", max(gaps), limits["answer_gap"])]


def _answer_gap(ref, resp, cfg) -> float:
    """How far a response lies from the reference's scoring of its own
    committee: the detections decoded from the committee mean (their
    count, then their scores) and the mean per-die top score."""
    c = resp.committee
    boxes, scores, classes = ref.detmap.decode_boxes(
        c.mean(axis=0), cfg["n_anchors"], cfg["n_classes"])
    keep = []
    for cls in np.unique(classes):
        idx = np.nonzero(classes == cls)[0]
        keep += list(idx[ref.detmap.nms(boxes[idx], scores[idx])])
    want = np.sort(scores[keep])[::-1] if keep else np.zeros(0)
    got = np.asarray(sorted((d.score for d in resp.detections),
                            reverse=True))
    if got.size != want.size:
        return float("inf")
    top = float(np.mean([_top_score(ref, d, cfg) for d in c]))
    return max([abs(resp.confidence.get("mean", np.nan) - top)]
               + [abs(float(a) - float(b)) for a, b in zip(got, want)])


def control(state: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """The reference at `precision` in the program's place, for requests
    of the first window's arrivals: fills `state` with responses that
    `check` reads."""
    from types import SimpleNamespace

    from reference import irc

    ctx, tr, cfg = state["ctx"], state["ctx"].traffic, state["ctx"].config
    ref = registry.load_reference(ctx.config_name)
    due, scenes = _arrivals(tr, ctx.seed, state["rate"], 60.0)
    state["due_scenes"] = {i: int(s) for i, s in enumerate(scenes)}
    responses = {}
    for rid in _picks(ctx, dict.fromkeys(range(len(due)))):
        scene = torch.from_numpy(
            state["scenes"][int(scenes[rid])][None]).to(ctx.device)
        c = ref.heads(state["weights"], cfg, scene,
                      sweeps.call_key(ctx.seed, rid, ctx.device),
                      list(range(tr["committee"])),
                      effects=irc.Effects(**tr["effects"]),
                      device=irc.Device.from_traffic(tr.get("device")),
                      precision=precision,
                      calib=state["calib"])[:, 0].cpu().numpy()
        responses[rid] = SimpleNamespace(
            committee=c, detections=[], confidence={"mean": float(np.mean(
                [_top_score(ref, d, cfg) for d in c]))})
    state["responses"] = responses
    return {}
