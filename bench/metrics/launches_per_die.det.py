"""Device kernel launches a die takes: every kernel the profiler saw in the
traced window, over the dies of the window."""
from benchkit.readers import per_die


def read(ctx):
    t = ctx["trace"]
    return None if t is None else per_die(ctx, t["launches"], 1.0)
