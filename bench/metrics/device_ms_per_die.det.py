"""Device milliseconds a die takes in the detector sweep: the `device_ms`
of the program's `mc_detector_chunks` spans (timing events from the end of
the previous chunk's work to this chunk's copy, bubbles included), summed
over the traced window and divided by its dies."""
from benchkit.readers import per_die
from benchkit.spans import device_ms, named


def read(ctx):
    ms = device_ms(named(ctx, "mc_detector_chunks"))
    return per_die(ctx, sum(ms), 1.0) if ms else None
