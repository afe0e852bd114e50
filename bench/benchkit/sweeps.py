"""What the drivers share: the program's detector, macro, effects and
device model from a configuration and a mix, per-call keys, the hand-over
from the program to the reference after a window, and the window loop
that calls a sweep back to back and counts only the dies finished inside
the window.

The program reports each finished chunk as a "chunk" event on the run log
it is given (`obs=`); `ChunkClock` is such a log that notes the time and
the running die count of each event and nothing else.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from benchkit import registry
from reference import threefry as tf

#: the key of the warm-up call, apart from every call index of a window
WARM_CALL = 0xFFFFFFFF


def macro_spec(cfg: Dict[str, Any]):
    """The program's `MacroSpec` at the configuration's constants; raises
    where the program derives another LRS current or sigma from them."""
    from repro_torch.core.macro import MacroSpec
    m = cfg["macro"]
    spec = MacroSpec(wl_voltage=m["wl_voltage"], ir_block=m["ir_block"],
                     ir_alpha=m["ir_alpha"], hrs_leak=m["hrs_leak"],
                     sense_low_ua=m["sense_low_ua"],
                     sense_high_ua=m["sense_high_ua"], sa_c0=m["sa_c0"],
                     sa_c1=m["sa_c1"], sa_c2=m["sa_c2"])
    if (abs(spec.i_lrs_ua - m["i_lrs_ua"]) > 1e-12
            or abs(spec.sigma_lrs - m["sigma_lrs"]) > 1e-12):
        raise ValueError("the program's macro disagrees with the "
                         "configuration's LRS current or sigma")
    return spec


def ternary_fractions(cfg: Dict[str, Any]) -> Tuple[float, float]:
    """The configuration's (low, high) ternary fractions, the shares of
    weights mapped to -1 and +1; raises unless the three shares sum to
    1."""
    lo, mid, hi = (float(f) for f in cfg["ternary_fractions"])
    if abs(lo + mid + hi - 1.0) > 1e-9:
        raise ValueError(f"ternary fractions {cfg['ternary_fractions']} "
                         f"do not sum to 1")
    return lo, hi


def threefry_scheme(cfg: Dict[str, Any]) -> None:
    """Puts the program on the configuration's threefry counter scheme;
    raises for any but "partitionable", the only one the reference
    implements."""
    from repro_torch import prng
    if cfg["threefry"] != "partitionable":
        raise ValueError(f"threefry scheme {cfg['threefry']!r}: the "
                         f"reference implements \"partitionable\" only")
    prng.set_threefry_partitionable(True)


def detector(cfg: Dict[str, Any]):
    """The program's `IRCDetector` at the configuration's sizes; raises
    where the configuration asks for ternary fractions other than the
    20/60/20 the program's detector quantises with."""
    from repro_torch.models.detector import DetectorConfig, IRCDetector
    if ternary_fractions(cfg) != (0.2, 0.2):
        raise ValueError("the program's detector maps ternary 20/60/20 "
                         "only")
    return IRCDetector(DetectorConfig(
        img_hw=tuple(cfg["img_hw"]), n_classes=cfg["n_classes"],
        n_anchors=cfg["n_anchors"], group=cfg["group"],
        stage_channels=tuple(cfg["stage_channels"]),
        blocks_per_stage=tuple(cfg["blocks_per_stage"]),
        scheme=cfg["scheme"], use_bn=cfg["use_bn"],
        accumulation=cfg["accumulation"], bias_rows=cfg["bias_rows"]),
        macro_spec(cfg))


def detector_params(det, weights: Dict[str, Any],
                    calib: torch.Tensor) -> Dict[str, Any]:
    """The program's parameter tree over the benchmark's weights, its stem
    BN calibrated by the program on `calib`."""
    p = dict(weights)
    c0 = weights["stem"].shape[-1]
    dev = weights["stem"].device
    p["stem_bn"] = dict(weights["stem_bn"],
                        mean=torch.zeros(c0, device=dev),
                        var=torch.ones(c0, device=dev))
    return det.calibrate_bn(p, calib)


def hand_over(state: Dict[str, Any], program: Tuple[str, ...]):
    """After the window: drop the program's objects from `state`, free the
    card's cache, turn TF32 off, and return the configuration's reference
    with the mix's effects and device for it."""
    from reference import irc
    for k in program:
        state.pop(k, None)
    ctx = state["ctx"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = ctx.traffic
    return (registry.load_reference(ctx.config_name),
            irc.Effects(**tr["effects"]),
            irc.Device.from_traffic(tr.get("device")))


def effects(names: Dict[str, bool]):
    """The program's `NonidealConfig` from a mix's "effects" group."""
    from repro_torch.core.nonideal import NonidealConfig
    return NonidealConfig(**names)


def device_model(d: Dict[str, Any]):
    """The program's device model from a mix's "device" group: the
    analytic one, or the measured table the mix carries, aged by
    "t_days"."""
    from repro_torch.device import MeasuredDeviceModel, get_device_model
    from repro_torch.device.retention import RetentionDrift
    d = d or {}
    t = float(d.get("t_days", 0.0))
    if d.get("model", "analytic") == "analytic":
        return get_device_model("analytic", t_days=t) if t else None
    data = d["data"]
    base = MeasuredDeviceModel(
        dataset=data["name"],
        var_q=tuple(float(v) for v in data["variation"]["quantile"]),
        var_factor=tuple(float(v) for v in data["variation"]["factor"]),
        iv_v=tuple(float(v) for v in data["iv"]["v"]),
        iv_lrs_ua=tuple(float(v) for v in data["iv"]["i_lrs_ua"]),
        iv_hrs_ua=tuple(float(v) for v in data["iv"]["i_hrs_ua"]))
    return RetentionDrift(base=base, t_days=t) if t else base


def call_key(seed: int, call: int, device) -> torch.Tensor:
    """Key of a window's call `call`: fold_in(PRNGKey(seed), call)."""
    return tf.fold_in(tf.key(seed), call).to(device)


def chunk_clock():
    """A run log for the program that notes (time, dies done) at each
    "chunk" event."""
    from repro_torch.obs.runlog import NullRunLog

    class ChunkClock(NullRunLog):
        def __init__(self):
            super().__init__()
            self.marks: List[Tuple[float, int]] = []

        def log_event(self, kind: str, **fields) -> None:
            if kind == "chunk":
                self.marks.append((time.perf_counter(), int(fields["chips"])))

    return ChunkClock()


def run_window(seconds: float, call: Callable[[int, Any], Any]
               ) -> Dict[str, Any]:
    """Call `call(i, clock)` for i = 0, 1, ... until `seconds` have passed
    (the last call runs to its end).  Dies count where their chunk ended
    inside the window.  Returns {"t0", "seconds", "dies_in_window",
    "dies_total", "calls": [result of each call], "traced_s": the wall
    from t0 to the last call's end}."""
    t0 = time.perf_counter()
    t_end = t0 + seconds
    done_in, done_all, results = 0, 0, []
    i = 0
    while time.perf_counter() < t_end:
        clock = chunk_clock()
        results.append(call(i, clock))
        before = 0
        for t, n in clock.marks:
            if t <= t_end:
                done_in += n - before
            done_all += n - before
            before = n
        i += 1
    return {"t0": t0, "seconds": seconds, "dies_in_window": done_in,
            "dies_total": done_all, "calls": results,
            "traced_s": time.perf_counter() - t0}
