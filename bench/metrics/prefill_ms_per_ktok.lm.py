"""Device milliseconds of the LM engine's prefill per 1,000 prefilled
tokens, pads included (the `device_ms` and `tokens` of the program's
`lm_prefill` spans, summed over the window's waves)."""
from benchkit.spans import named


def read(ctx):
    spans = [s for s in named(ctx, "lm_prefill") if "device_ms" in s["ids"]]
    tokens = sum(s["ids"]["tokens"] for s in spans)
    if not tokens:
        return None
    return 1e3 * sum(s["ids"]["device_ms"] for s in spans) / tokens
