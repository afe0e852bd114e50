"""The LM service's model FLOPs over the traced window, as a share of the
bf16 dense peak: 2 x the multiply-accumulates of every answered request's
tokens (`lm_roofline.request_macs`: the prompt and the fed answer tokens,
each with its context, pads left out)."""
from benchkit import lm_roofline
from benchkit.readers import mfu


def read(ctx):
    macs = sum(lm_roofline.request_macs(ctx["config"], p, a)
               for p, a in ctx["window"].get("lengths", ()))
    return mfu(ctx, 2.0 * macs)
