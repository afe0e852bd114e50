"""K1's share of its roofline in the layer sweep: each launch's least time
(`roofline.k1_least_s` at the chunk's shapes) over K1's device time."""
from benchkit.readers import k1_share, layer_least_per_launch


def read(ctx):
    return k1_share(ctx, layer_least_per_launch(ctx))
