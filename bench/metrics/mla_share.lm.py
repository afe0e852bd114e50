"""% of the LM engine's prefill device time spent inside the latent
attention of the layers: the `device_ms` of the program's prefill
`mla_attend` spans (timing events around each layer's attention) over
that of its `lm_prefill` spans.  Decode is left out: on the card its
step runs as captured CUDA graphs, inside which no span opens."""
from benchkit.spans import device_ms, named


def read(ctx):
    mla = device_ms([s for s in named(ctx, "mla_attend")
                     if s["ids"].get("kind") == "prefill"])
    whole = device_ms(named(ctx, "lm_prefill"))
    if not mla or not sum(whole):
        return None
    return 100.0 * sum(mla) / sum(whole)
