"""Device microseconds a die takes in the layer sweep: the `device_ms` of
the program's `mc_chunks` spans (timing events from before a chunk's first
launch to after its last), summed over the traced window and divided by
its dies."""
from benchkit.readers import per_die
from benchkit.spans import device_ms, named


def read(ctx):
    ms = device_ms(named(ctx, "mc_chunks"))
    return per_die(ctx, sum(ms), 1e3) if ms else None
