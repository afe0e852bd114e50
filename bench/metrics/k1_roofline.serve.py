"""K1's share of its roofline in the service: each launch's least time (a
lane is one image through a committee, `roofline.k1_least_s` at its
shapes) over K1's device time."""
from benchkit import roofline
from benchkit.readers import k1_share


def read(ctx):
    launches = roofline.detector_k1_launches(
        ctx["config"], ctx["traffic"]["committee"], 1)
    return k1_share(ctx, roofline.least_s(launches) / len(launches))
