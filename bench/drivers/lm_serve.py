"""Driver of the LM service: the program's `serve/engine.py::ServeEngine`
on a language model of its registry (the configuration's name is the
program's `--arch`), waves of up to `slots` requests, each wave one
`generate` call: `LM.prefill` of the left-padded prompts, then greedy
decode to the wave's longest answer (no EOS); a request's answer is its
first `answer` tokens.

Arrivals are open-loop Poisson at the mix's `rate` (requests/s) on one
schedule for every seed, drawn from the mix's `schedule_seed` with each
request's prompt length (log-normal around `prompt_median`, clipped to
`prompt_min`..`prompt_max`) and answer length (uniform over
`answer_min`..`answer_max`); the seed draws the weights (`LM.init` at
`PRNGKey(seed)`; the MoE layers' selection bias N(0, `score_bias_std`^2)
from a generator seeded with the seed) and the prompts' tokens, uniform
over the vocabulary.  A wave takes the requests due at its start, up to
`slots`, in order; with none due it waits for the next.  A request is
timed from when it was due until its wave returned, and one unanswered a
minute after the window closed counts as failed, at `FAILED_S`.

The arch is resolved first, so a program without it fails before
anything is allocated.  At full size the program's configuration must be
the configuration file's (`published`); on a device other than CUDA (the
CPU tests) the program's smoke configuration runs with the mix's `cpu`
sizes.  Set-up serves a full wave of distinct prompts at the longest
prompt through the longest answer, and one at the shortest, so the
cache, the allocator's pools and the libraries' kernels are warm and the
largest wave's memory is reached before the window.

Check: `sample_requests` requests drawn from the seed before the window;
the engine's logits of each at every position it produced them for (the
last prompt position and each decode step that fed one of its answer
tokens) go to pinned host memory as they come (`logits_hook`), as do the
experts each MoE layer chose for its positions (`LM.route_log`, on the
waves that serve a sampled request), so the check keeps little on the
card and adds no wait.  After the window the plain reference (float32,
layer by layer) is fed the same left-padded prompt, the program's own
answer tokens and the program's own choice of experts: discrete decisions
that bf16 rounding flips at near-ties, as it flips the greedy token, and
that would otherwise part the two runs for good.  `logits_over_tol` is
the share of positions whose relative L2 error over the vocabulary
exceeds the mix's `rel_l2_tol`; `routes_off_topk` the share of
(position, MoE layer) routings where the program's choice is not a top-k
of the reference's selection scores within `route_slack` (the largest
score left out exceeds the smallest taken by more).  Both limits are 0.
A request not answered counts as over on both.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchkit import registry

#: latency recorded for an unanswered request (s)
FAILED_S = 1000.0
#: seconds past the window's close that a due request may still take
GRACE_S = 60.0
#: request id of the warm-up waves' prompts, apart from every window's
WARM_ID = 0x7FFF0000
#: `control`'s precision for a configuration in bf16: the one below it
BELOW_BF16 = "fp8"


def _sizes(ctx) -> Dict[str, Any]:
    """The mix's lengths: its own on CUDA, its `cpu` group elsewhere."""
    tr = ctx.traffic
    return dict(tr, **tr["cpu"]) if ctx.device.type != "cuda" else tr


def schedule(ctx, rate: float, seconds: float
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(due offsets from the window's start, prompt lengths, answer
    lengths) of the requests due below `seconds`, the same for every
    seed."""
    tr, sz = ctx.traffic, _sizes(ctx)
    rng = np.random.default_rng((tr["schedule_seed"], 5))
    n = int(rate * seconds * 2 + 64)
    due = np.cumsum(rng.exponential(1.0 / rate, size=n))
    lens = np.exp(rng.normal(np.log(sz["prompt_median"]),
                             tr["prompt_sigma"], size=n))
    lens = np.clip(np.rint(lens), sz["prompt_min"], sz["prompt_max"])
    answers = rng.integers(sz["answer_min"], sz["answer_max"] + 1, size=n)
    keep = due < seconds
    return due[keep], lens[keep].astype(np.int64), answers[keep]


def prompt(ctx, rid: int, n: int, vocab: int) -> List[int]:
    """Request `rid`'s `n` prompt tokens, uniform over the vocabulary."""
    rng = np.random.default_rng((ctx.seed, 7, rid))
    return [int(t) for t in rng.integers(0, vocab, size=n)]


def published(cfg) -> Dict[str, Any]:
    """The program's configuration under the published config.json keys
    that the plain reference reads."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim,
            "intermediate_size": cfg.dense_d_ff,
            "moe_intermediate_size": cfg.d_ff,
            "first_k_dense_replace": cfg.n_dense_prefix,
            "n_routed_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.top_k,
            "n_shared_experts": cfg.n_shared_experts,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "norm_topk_prob": True,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "vocab_size": cfg.vocab_size,
            "tie_word_embeddings": cfg.tie_embeddings}


def program_config(ctx):
    """The program's configuration of the cell's model; ValueError where
    the program's full configuration is not the configuration file's."""
    from repro_torch.configs.registry import get_config

    full = ctx.device.type == "cuda"
    cfg = get_config(ctx.config_name, "full" if full else "smoke")
    if full:
        have = published(cfg)
        apart = {k: (v, ctx.config.get(k)) for k, v in have.items()
                 if ctx.config.get(k) != v}
        if apart or cfg.dtype != ctx.config["dtype"]:
            raise ValueError(f"the program's {ctx.config_name} is not the "
                             f"configuration: {apart or cfg.dtype}")
    return cfg


def reference_weights(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The program's parameters (views) in the plain reference's layout."""
    layers = []
    for name in sorted(k for k in params if k.startswith("seg")):
        seg = params[name]
        for l in range(seg["ln1"].shape[0]):
            lw = {"ln1": seg["ln1"][l], "ln2": seg["ln2"][l],
                  **{k: v[l] for k, v in seg["attn"].items()}}
            if "moe" in seg:
                m = seg["moe"]
                lw.update({k: m[k][l] for k in ("router", "score_bias",
                                                 "w_gate", "w_up",
                                                 "w_down")},
                          shared={k: v[l] for k, v in m["shared"].items()})
            else:
                lw["mlp"] = {k: v[l] for k, v in seg["mlp"].items()}
            layers.append(lw)
    return {"embed": params["embed"], "unembed": params["unembed"],
            "final_norm": params["final_norm"], "layers": layers}


def make_inputs(ctx) -> Dict[str, Any]:
    """The program's configuration (resolved first), then the weights from
    the seed on the device."""
    cfg = program_config(ctx)
    from repro_torch import prng
    from repro_torch.models.transformer import LM

    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(ctx.seed, device=ctx.device),
                     device=ctx.device)
    g = torch.Generator(device=ctx.device)
    g.manual_seed(ctx.seed)
    for name in sorted(params):
        if name.startswith("seg") and "moe" in params[name]:
            bias = params[name]["moe"]["score_bias"]
            bias.copy_(torch.randn(bias.shape, generator=g,
                                   device=ctx.device)
                       * ctx.traffic["score_bias_std"])
    return {"ctx": ctx, "cfg": cfg, "lm": lm, "params": params,
            "rate": float(ctx.traffic["rate"])}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` copied into host memory behind the work queued before it (pinned
    on a card, so the copy waits for nothing and takes no card memory)."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


class _Watch:
    """The logits hook: copies to the host the logits of the watched
    requests of the wave being served at the steps that made their
    answers."""

    def __init__(self, watched: List[int]):
        self.watched = set(watched)
        self.wave: List[int] = []
        self.answers: Dict[int, int] = {}
        self.logits: Dict[int, List[torch.Tensor]] = {}

    def __call__(self, wave: int, step: int, logits: torch.Tensor) -> None:
        for slot, rid in enumerate(self.wave):
            if rid in self.watched and step < self.answers[rid]:
                self.logits.setdefault(rid, []).append(
                    _to_host(logits[slot, -1].float()))


def setup(ctx) -> Dict[str, Any]:
    from repro_torch.serve.engine import ServeEngine

    state = make_inputs(ctx)
    sz = _sizes(ctx)
    watch = _Watch([])
    engine = ServeEngine(state["lm"], state["params"],
                         batch_slots=ctx.traffic["slots"],
                         max_len=sz["max_len"], seed=ctx.seed,
                         logits_hook=watch)
    vocab, slots = state["cfg"].vocab_size, ctx.traffic["slots"]
    for n, new in ((sz["prompt_max"], sz["answer_max"]),
                   (sz["prompt_min"], 2)):
        engine.generate([prompt(ctx, WARM_ID + i, n, vocab)
                         for i in range(slots)], max_new_tokens=new)
    state.update(engine=engine, watch=watch, rid0=0)
    return state


def _picks(ctx, n_due: int, rid0: int) -> List[int]:
    """`sample_requests` request ids among the window's, from the seed."""
    rng = np.random.default_rng((ctx.seed, 2))
    n = min(ctx.traffic["sample_requests"], n_due)
    return sorted(rid0 + int(i) for i in rng.choice(n_due, n, replace=False))


def window(state: Dict[str, Any], seconds: float) -> Dict[str, Any]:
    ctx, cfg, lm = state["ctx"], state["cfg"], state["lm"]
    engine, watch = state["engine"], state["watch"]
    slots = ctx.traffic["slots"]
    routes: Dict[int, List[torch.Tensor]] = {}
    due, lens, answers = schedule(ctx, state["rate"], seconds)
    rid0 = state["rid0"]
    picks = _picks(ctx, len(due), rid0)
    watch.watched, watch.logits = set(picks), {}
    watch.answers = {rid0 + i: int(a) for i, a in enumerate(answers)}
    done: Dict[int, Tuple[List[int], int, float]] = {}
    wave_wall, wave_requests = [], []
    nxt, pending = 0, []
    t0 = time.perf_counter()
    deadline = t0 + seconds + GRACE_S
    while nxt < len(due) or pending:
        now = time.perf_counter()
        if now > deadline:
            break
        while nxt < len(due) and t0 + due[nxt] <= now:
            pending.append(nxt)
            nxt += 1
        if not pending:
            time.sleep(max(t0 + due[nxt] - now, 0.0))
            continue
        wave, pending = pending[:slots], pending[slots:]
        prompts = [prompt(ctx, rid0 + i, int(lens[i]), cfg.vocab_size)
                   for i in wave]
        watch.wave = [rid0 + i for i in wave]
        lm.route_log = [] if watch.watched.intersection(watch.wave) \
            else None
        out = engine.generate(prompts,
                              max_new_tokens=int(max(answers[i]
                                                     for i in wave)))
        t_done = time.perf_counter()
        wave_wall.append(t_done - now)
        wave_requests.append(len(wave))
        pad = max(len(p) for p in prompts)
        for slot, (i, r) in enumerate(zip(wave, out)):
            done[rid0 + i] = (r.tokens[:int(answers[i])],
                              pad - int(lens[i]), t_done - t0 - due[i])
            if rid0 + i in watch.watched:
                routes[rid0 + i] = _routes(lm.route_log, cfg, slots, slot,
                                           int(answers[i]))
        lm.route_log = None
    t_close = t0 + seconds
    lat = np.asarray([done[rid0 + i][2] if rid0 + i in done else FAILED_S
                      for i in range(len(due))], np.float64)
    failed = int((lat >= FAILED_S).sum())
    served = [i for i in range(len(due)) if rid0 + i in done]
    state.update(picks=picks, responses={
        rid: {"prompt": prompt(ctx, rid, int(lens[rid - rid0]),
                               cfg.vocab_size),
              "answer": done[rid][0], "pad": done[rid][1],
              "logits": watch.logits.get(rid, []),
              "routes": routes.get(rid)}
        for rid in picks if rid in done})
    state["rid0"] = rid0 + len(due)
    return {"metrics": {"serve_p95_s": float(np.percentile(lat, 95))
                        if lat.size else FAILED_S},
            "attempted": int(lat.size), "failed": failed,
            "raw": {"requests": len(served),
                    "traced_s": time.perf_counter() - t0,
                    "refused": 0,
                    "answered_after_close": int(sum(
                        t0 + due[i] + lat[i] > t_close for i in served)),
                    "p50_s": float(np.percentile(lat, 50))
                    if lat.size else FAILED_S,
                    "late_p95_s": 0.0,
                    "wave_wall_s": wave_wall,
                    "wave_requests": wave_requests,
                    "lengths": [[int(lens[i]), int(answers[i])]
                                for i in served]}}


def _routes(log: List[torch.Tensor], cfg, slots: int, slot: int,
            answer: int) -> List[torch.Tensor]:
    """One request's chosen experts per MoE layer [positions, k] from a
    wave's `route_log` (the prefill's layers [slots x prompt, k], then each
    decode step's [slots, k]): its prompt's rows, then the steps that fed
    its first `answer` - 1 answer tokens."""
    n = cfg.n_layers - cfg.n_dense_prefix
    steps = [log[j:j + n] for j in range(n, len(log), n)][:answer - 1]
    return [_to_host(torch.cat([log[l].view(slots, -1, cfg.top_k)[slot]]
                               + [step[l][slot:slot + 1] for step in steps]))
            for l in range(n)]


def _rel_l2(prog: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    """Per row: ||prog - ref|| / ||ref|| (inf where prog is not finite)."""
    err = torch.linalg.vector_norm(prog.double() - ref.double(), dim=-1) \
        / torch.linalg.vector_norm(ref.double(), dim=-1)
    err = torch.where(torch.isfinite(prog).all(dim=-1), err,
                      torch.full_like(err, float("inf")))
    return err.cpu().numpy()


def check(state: Dict[str, Any], result: Dict[str, Any]
          ) -> List[Tuple[str, float, float]]:
    ctx, cfg = state["ctx"], state["cfg"]
    limits, tol = ctx.traffic["limits"], ctx.traffic["rel_l2_tol"]
    slack = ctx.traffic["route_slack"]
    ref = registry.load_reference(ctx.config_name)
    weights = reference_weights(state["params"], cfg)
    rcfg = published(cfg)
    for k in ("engine", "watch", "lm"):
        state.pop(k, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    over, total, worst = 0, 0, 0.0
    off, routed, margin = 0, 0, float("-inf")
    for rid in state.get("picks", []):
        r = state["responses"].get(rid)
        if r is None or len(r["logits"]) != len(r["answer"]) \
                or not r["answer"] or r["routes"] is None:
            n = len(r["answer"]) if r and r["answer"] else 1
            over, total, worst = over + n, total + n, float("inf")
            off, routed = off + 1, routed + 1
            continue
        seq = [0] * r["pad"] + r["prompt"] + r["answer"][:-1]
        last = r["pad"] + len(r["prompt"]) - 1
        positions = list(range(last, last + len(r["answer"])))
        stats: Dict[str, List[torch.Tensor]] = {}
        want = ref.logits(weights, rcfg,
                          torch.tensor(seq, device=ctx.device), positions,
                          routes=[t.to(ctx.device) for t in r["routes"]],
                          stats=stats)
        err = _rel_l2(torch.stack(r["logits"]).to(want.device), want)
        over += int((err > tol).sum())
        total += err.size
        worst = max(worst, float(err.max()))
        below = torch.cat(stats["below"])
        off += int((below > slack).sum())
        routed += below.numel()
        margin = max(margin, float(below.max()))
    if not total:
        return [("logits_over_tol", 1.0, limits["logits_over_tol"]),
                ("routes_off_topk", 1.0, limits["routes_off_topk"])]
    print(f"lm check: worst relative L2 {worst!r} over {total} positions "
          f"of {len(state.get('picks', []))} requests (tol {tol!r}); "
          f"largest selection score left out over the smallest taken "
          f"{margin!r} over {routed} routings (slack {slack!r})",
          file=sys.stderr)
    return [("logits_over_tol", over / total, limits["logits_over_tol"]),
            ("routes_off_topk", off / routed, limits["routes_off_topk"])]


def control(state: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """The reference at the precision below the configuration's in the
    program's place (bf16: float8 e4m3; "tf32", `control.py`'s default
    for float32 configurations, is not below bf16 and stands for it), for
    requests of the first window's schedule with answers drawn from the
    seed, unpadded: fills `state` with the responses `check` reads."""
    ctx, cfg = state["ctx"], state["cfg"]
    if precision == "tf32" and cfg.dtype == "bfloat16":
        precision = BELOW_BF16
    ref = registry.load_reference(ctx.config_name)
    weights = reference_weights(state["params"], cfg)
    rcfg = published(cfg)
    due, lens, answers = schedule(ctx, state["rate"], 60.0)
    picks = _picks(ctx, len(due), 0)
    rng = np.random.default_rng((ctx.seed, 9))
    responses = {}
    for rid in picks:
        p = prompt(ctx, rid, int(lens[rid]), cfg.vocab_size)
        a = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                          size=int(answers[rid]))]
        seq = torch.tensor(p + a[:-1], device=ctx.device)
        positions = list(range(len(p) - 1, len(p) - 1 + len(a)))
        stats: Dict[str, List[torch.Tensor]] = {}
        got = ref.logits(weights, rcfg, seq, positions, precision=precision,
                         stats=stats)
        responses[rid] = {"prompt": p, "answer": a, "pad": 0,
                          "logits": list(got), "routes": stats["routes"]}
    state.update(picks=picks, responses=responses)
    return {}
