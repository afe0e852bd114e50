"""Arithmetic the per-layer readers (`bench/metrics/*.py`) share.  A
reader gets {"cell", "config", "traffic", "window" (the driver's raw
numbers), "trace" (`trace.reduce_events` of the traced window, or None)}
and returns a number, or None where the run gave it nothing to read."""
from __future__ import annotations

from typing import Any, Dict, Optional

from benchkit import roofline
from benchkit.trace import kernel_seconds

#: K1's kernel name and the die-sampling kernels' names in the program
K1 = ("irc_mvm_chips_kernel",)
THREEFRY = ("draw_kernel", "pairs_kernel", "tail_kernel")


def per_die(ctx: Dict[str, Any], value: Optional[float],
            scale: float) -> Optional[float]:
    """value / dies of the traced window, times `scale`."""
    dies = ctx["window"].get("dies", 0)
    if value is None or not dies:
        return None
    return value / dies * scale


def idle_share(ctx: Dict[str, Any]) -> Optional[float]:
    """% of the traced window in which nothing ran on the device."""
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx: Dict[str, Any], flops: float) -> Optional[float]:
    """% of the bf16 dense peak that `flops` of model work over the traced
    window is."""
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0 or not flops:
        return None
    return 100.0 * flops / t["window_s"] / roofline.PEAK_BF16_FLOPS


def k1_share(ctx: Dict[str, Any], least_per_launch: float
             ) -> Optional[float]:
    """% of K1's device time that its least time is, over every K1 launch
    of the traced window, each priced at `least_per_launch` seconds."""
    t = ctx["trace"]
    if t is None:
        return None
    n, secs = kernel_seconds(t, *K1)
    if not n or secs <= 0:
        return None
    return 100.0 * n * least_per_launch / secs


def detector_least_per_launch(ctx: Dict[str, Any]) -> float:
    """Mean least time of one K1 launch of a detector chunk."""
    tr = ctx["traffic"]
    launches = roofline.detector_k1_launches(ctx["config"], tr["chunk"],
                                             tr["images"])
    return roofline.least_s(launches) / len(launches)


def layer_least_per_launch(ctx: Dict[str, Any]) -> float:
    """Least time of one K1 launch of a layer chunk."""
    cfg = ctx["config"]
    return roofline.k1_least_s(ctx["traffic"]["chunk"], cfg["batch"],
                               cfg["fan_in"] + cfg["bias_rows"],
                               cfg["n_out"], per_chip_x=False)[0]
