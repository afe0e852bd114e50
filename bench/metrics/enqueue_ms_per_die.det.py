"""Host milliseconds a die spends enqueueing its sampling and forward (the
program's enqueue laps, `McResult.enqueue_s`), over the traced window."""
from benchkit.readers import per_die


def read(ctx):
    return per_die(ctx, ctx["window"].get("enqueue_s"), 1e3)
