"""Driver of the macro layer's Table II sweep: the program's
`mc/engine.py::run_mc` (the fused IRC MVM route, `backend="kernel"`),
called back to back on fresh die populations, call i keyed
fold_in(PRNGKey(seed), i), each call `chunks_per_call` chunks of `chunk`
dies on one batch of input vectors.  A die counts when its chunk's bit
agreement was computed inside the window.

Set-up: latent weights and input bits on the card from the seed, the
ideal decisions they give (the reference's, exact), the program's ternary
mapping of the weights, and one warm-up call of one chunk.

Check: the SA decisions of `sample_dies` dies drawn from the seed among
the first `sample_calls` calls, as the program computed them (kept on the
card through a per-chunk metric of the program's), against the plain
reference's on the same inputs and keys (`bits_mismatch`: the share of
decisions apart); and each sampled die's bit agreement as the program
reported it against the agreement of those same decisions with the ideal
ones (`agreement_gap`, in decisions: exact).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchkit import inputs, judge, registry, sweeps


def make_inputs(ctx) -> Dict[str, Any]:
    """The benchmark's own inputs, from the seed: latent weights, input
    bits and their ideal decisions."""
    ref = registry.load_reference(ctx.config_name)
    w, x = inputs.layer_inputs(ctx.config, ctx.seed, ctx.device)
    return {"ctx": ctx, "w": w, "x": x,
            "ideal": ref.ideal(ctx.config, w, x)}


def setup(ctx) -> Dict[str, Any]:
    from repro_torch.core.mapping import ternary_planes
    from repro_torch.core.ternary import ternary_quantize
    from repro_torch.mc.engine import McConfig, run_mc

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    sweeps.threefry_scheme(cfg)
    state = make_inputs(ctx)
    spec = sweeps.macro_spec(cfg)
    w, x, ideal = state["w"], state["x"], state["ideal"]
    lo, hi = sweeps.ternary_fractions(cfg)
    mapped = ternary_planes(ternary_quantize(w, lo_frac=lo, hi_frac=hi),
                            bias_rows=cfg["bias_rows"])
    mc = McConfig(n_chips=tr["chunk"] * tr["chunks_per_call"],
                  chunk_size=tr["chunk"], cfg=sweeps.effects(tr["effects"]),
                  backend=tr["backend"],
                  device=sweeps.device_model(tr.get("device")))
    state.update(mapped=mapped, spec=spec, mc=mc, run=run_mc)
    run_mc(sweeps.call_key(ctx.seed, sweeps.WARM_CALL, dev), mapped, x,
           ref_bits=ideal, mc=dataclasses.replace(mc, n_chips=tr["chunk"]),
           spec=spec)
    return state


def _sample(ctx) -> List[Tuple[int, int]]:
    """(call, die) pairs to check, drawn from the seed: half of them in the
    first call, which every window runs, the rest among the first
    `sample_calls` calls."""
    tr = ctx.traffic
    per_call = tr["chunk"] * tr["chunks_per_call"]
    rng = np.random.default_rng((ctx.seed, 2))
    n = tr["sample_dies"]
    first = rng.choice(per_call, size=n // 2, replace=False)
    rest = rng.choice(np.arange(per_call, tr["sample_calls"] * per_call),
                      size=n - n // 2, replace=False)
    return sorted((int(p) // per_call, int(p) % per_call)
                  for p in [*first, *rest])


def window(state: Dict[str, Any], seconds: float) -> Dict[str, Any]:
    from torch.autograd.profiler import record_function

    ctx, tr = state["ctx"], state["ctx"].traffic
    chunk = tr["chunk"]
    picks = _sample(ctx)
    calls = {c for c, _ in picks}
    kept: Dict[Tuple[int, int], torch.Tensor] = {}

    def keeper(call: int):
        """A per-chunk metric that keeps the sampled dies' decisions on the
        card and reports zeros."""
        at = {"chunk": 0}
        mine = {d for c, d in picks if c == call}

        def keep(out: torch.Tensor) -> torch.Tensor:
            lo = at["chunk"] * chunk
            local = [d - lo for d in sorted(mine) if lo <= d < lo + chunk]
            if local:
                sel = out[torch.tensor(local, device=out.device)].clone()
                for j, d in enumerate(local):
                    kept[(call, lo + d)] = sel[j]
            at["chunk"] += 1
            return out.new_zeros(out.shape[0])
        return keep

    def one_call(i: int, clock):
        with record_function("bench.run_mc"):
            return state["run"](
                sweeps.call_key(ctx.seed, i, ctx.device), state["mapped"],
                state["x"], ref_bits=state["ideal"], mc=state["mc"],
                spec=state["spec"], obs=clock,
                metric_fns={"kept": keeper(i)} if i in calls else None)

    w = sweeps.run_window(seconds, one_call)
    res = w["calls"]
    state["kept"] = kept
    state["n_calls"] = len(res)
    return {"metrics": {"layer_dies_per_s": w["dies_in_window"] / seconds},
            "attempted": w["dies_in_window"], "failed": 0,
            "raw": {"dies": w["dies_total"], "traced_s": w["traced_s"],
                    "chunk": chunk,
                    "enqueue_s": sum(r.enqueue_s for r in res)},
            "per_chip": [r.per_chip["bit_agreement"] for r in res]}


def check(state: Dict[str, Any], result: Dict[str, Any]
          ) -> List[Tuple[str, float, float]]:
    ctx, tr, cfg = state["ctx"], state["ctx"].traffic, state["ctx"].config
    limits = tr["limits"]
    picks = [p for p in _sample(ctx) if p[0] < state["n_calls"]]
    kept = {k: v.cpu() for k, v in state.pop("kept").items()}
    ref, effects, device = sweeps.hand_over(state, ("mapped", "mc", "run"))
    prog, want, gaps = [], [], []
    ideal = state["ideal"].cpu()
    n = ideal.numel()
    for call in sorted({c for c, _ in picks}):
        dies = [d for c, d in picks if c == call]
        r = ref.bits(cfg, state["w"], state["x"],
                     sweeps.call_key(ctx.seed, call, ctx.device), dies,
                     effects=effects, device=device).cpu()
        for j, d in enumerate(dies):
            p = kept.get((call, d))
            ok = p is not None and p.shape == r[j].shape
            prog.append(p.numpy() if ok
                        else np.full(tuple(r[j].shape), np.nan))
            want.append(r[j].numpy())
            # decisions agreeing with the ideal ones, reported and counted
            reported = round(float(result["per_chip"][call][d]) * n)
            gaps.append(abs(reported - int(ref.agreement(p, ideal) * n
                                          + 0.5)) if ok else float("inf"))
    return [("bits_mismatch",
             judge.mismatch_share(np.stack(prog), np.stack(want), 0.5),
             limits["bits_mismatch"]),
            ("agreement_gap", float(max(gaps)), limits["agreement_gap"])]


def control(state: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """The reference at `precision` in the program's place: fills
    `state` and returns the window record that `check` reads, for the
    dies that a window's check samples."""
    from reference import irc

    ctx, tr = state["ctx"], state["ctx"].traffic
    ref = registry.load_reference(ctx.config_name)
    kept, per_chip = {}, {}
    picks = _sample(ctx)
    for call in sorted({c for c, _ in picks}):
        dies = [d for c, d in picks if c == call]
        b = ref.bits(ctx.config, state["w"], state["x"],
                     sweeps.call_key(ctx.seed, call, ctx.device), dies,
                     effects=irc.Effects(**tr["effects"]),
                     device=irc.Device.from_traffic(tr.get("device")),
                     precision=precision)
        a = ref.agreement(b, state["ideal"])
        for j, d in enumerate(dies):
            kept[(call, d)] = b[j]
            per_chip.setdefault(call, {})[d] = float(a[j])
    state.update(kept=kept, n_calls=tr["sample_calls"])
    return {"per_chip": per_chip}
