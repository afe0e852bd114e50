"""How unevenly the routed experts are loaded: the pairs routed to each
MoE layer's busiest expert over the mean expert's, summed over layers
and over the window's waves (the `expert_busiest` and `expert_mean` the
program tallies on the card per wave, on its `lm_wave` spans)."""
from benchkit.spans import named


def read(ctx):
    waves = [s["ids"] for s in named(ctx, "lm_wave")
             if "expert_busiest" in s["ids"]]
    mean = sum(w["expert_mean"] for w in waves)
    if not mean:
        return None
    return sum(w["expert_busiest"] for w in waves) / mean
