"""The layer sweep's model FLOPs (2 x batch x rows x outputs a die) over
the traced window, as a share of the bf16 dense peak."""
from benchkit import roofline
from benchkit.readers import mfu


def read(ctx):
    return mfu(ctx, 2.0 * roofline.layer_macs(ctx["config"])
               * ctx["window"].get("dies", 0))
