"""% of the traced window in which the service's scheduler waited on an
empty queue with nothing in flight (the program's `serve_idle` spans): at
a fixed arrival rate a faster engine waits more."""
from benchkit.spans import named, seconds


def read(ctx):
    if not named(ctx, "serve_wave") or ctx["trace"]["window_s"] <= 0:
        return None
    idle = sum(seconds(s) for s in named(ctx, "serve_idle"))
    return 100.0 * idle / ctx["trace"]["window_s"]
