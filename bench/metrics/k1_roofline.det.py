"""K1's share of its roofline in the detector sweep: each K1 launch's least
time (`roofline.k1_least_s` at the chunk's shapes) over K1's device time."""
from benchkit.readers import detector_least_per_launch, k1_share


def read(ctx):
    return k1_share(ctx, detector_least_per_launch(ctx))
