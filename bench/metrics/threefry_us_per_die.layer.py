"""Device microseconds a die spends in the die-sampling kernels (threefry's
draw, pairs and tail kernels, by name), over the traced window."""
from benchkit.readers import THREEFRY, per_die
from benchkit.trace import kernel_seconds


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    n, secs = kernel_seconds(t, *THREEFRY)
    return per_die(ctx, secs, 1e6) if n else None
