"""The detector sweep's model FLOPs (2 x the multiply-accumulates of stem,
group convolutions and head, per image and die) over the traced window, as
a share of the bf16 dense peak."""
from benchkit import roofline
from benchkit.readers import mfu


def read(ctx):
    w = ctx["window"]
    return mfu(ctx, 2.0 * roofline.detector_macs(ctx["config"])
               * w["images"] * w.get("dies", 0))
