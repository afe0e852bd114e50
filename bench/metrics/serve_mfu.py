"""The service's model FLOPs (2 x the detector's multiply-accumulates per
image, times the committee, per answered request) over the traced window,
as a share of the bf16 dense peak."""
from benchkit import roofline
from benchkit.readers import mfu


def read(ctx):
    w = ctx["window"]
    return mfu(ctx, 2.0 * roofline.detector_macs(ctx["config"])
               * w["committee"] * w.get("requests", 0))
