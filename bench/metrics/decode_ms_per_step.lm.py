"""Device milliseconds of one decode step of the LM engine's waves (the
`device_ms` of the program's `lm_decode` spans over their `steps`)."""
from benchkit.spans import named


def read(ctx):
    spans = [s for s in named(ctx, "lm_decode") if "device_ms" in s["ids"]]
    steps = sum(s["ids"].get("steps", 0) for s in spans)
    if not steps:
        return None
    return sum(s["ids"]["device_ms"] for s in spans) / steps
