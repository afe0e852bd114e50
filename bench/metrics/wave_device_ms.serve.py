"""Mean device milliseconds of one wave of the service: timing events from
just before the wave's first launch to its copy's landing (the `device_ms`
of the program's `serve_wave` spans)."""
from benchkit.spans import device_ms, named


def read(ctx):
    ms = device_ms(named(ctx, "serve_wave"))
    return sum(ms) / len(ms) if ms else None
