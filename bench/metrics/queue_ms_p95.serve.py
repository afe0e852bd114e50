"""p95 of the milliseconds a request answered in the traced window waited
from its submit until its wave was dispatched (the program's `serve_queue`
spans of the requests with a `serve_respond` span)."""
import numpy as np

from benchkit.spans import named, seconds


def read(ctx):
    answered = {s["ids"]["request"] for s in named(ctx, "serve_respond")}
    ms = [seconds(s) * 1e3 for s in named(ctx, "serve_queue")
          if s["ids"]["request"] in answered]
    return float(np.percentile(ms, 95)) if ms else None
