"""The MLA block (Moonlight-16B-A3B, `configs/moonlight_16b_a3b.py`) at its
smoke widths on the CPU, against the plain float32 reference of
`tests/moonlight_reference.py`: batched prefill then decode through the
latent cache at every position (left-padded rows too), the absorbed decode
against the expanded attention, the sigmoid routing with its selection
bias, the dropless experts and the shared ones, the serving engine through
`LM.prefill`, the spans and the expert tally while a trace runs, and the
registry beside the reference's ten."""
import dataclasses

import pytest
import torch

import moonlight_reference as mref
from repro_torch import prng
from repro_torch.configs import registry as treg
from repro_torch.configs.moonlight_16b_a3b import ARCH_ID, full, smoke
from repro_torch.models import mla, moe
from repro_torch.models.lm_config import MLAConfig
from repro_torch.models.transformer import LM
from repro_torch.obs import spans
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(2)
CPU = torch.device("cpu")
#: float32 on both sides, summed in other orders: relative L2 per position
TOL = 1e-5


def _model(seed=3, **changes):
    cfg = dataclasses.replace(smoke(), **changes)
    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(seed, device=CPU), device=CPU)
    g = torch.Generator().manual_seed(seed)
    for name, seg in params.items():
        if name.endswith("mla_moe"):
            seg["moe"]["score_bias"].copy_(
                torch.randn(seg["moe"]["score_bias"].shape, generator=g)
                * 0.05)
    return cfg, lm, params


def _rel(a, b):
    return (torch.linalg.vector_norm((a - b).double(), dim=-1)
            / torch.linalg.vector_norm(b.double(), dim=-1))


def test_full_config_counts():
    cfg = full()
    assert isinstance(cfg, MLAConfig) and cfg.block == "mla"
    assert cfg.param_count() == 15_960_110_208
    assert cfg.active_param_count() == 2_914_776_192
    assert cfg.latent_dim == 576 and cfg.head_dim == 192
    # the abstract tree holds every parameter the count names
    n = sum(t.numel() for t in
            torch.utils._pytree.tree_leaves(LM(cfg).abstract_params()))
    assert n == cfg.param_count()


def test_registry_keeps_the_references_ten():
    from repro.configs import registry as jreg
    assert treg.list_archs() == jreg.list_archs()
    assert treg.ARCH_STATUS == jreg.ARCH_STATUS
    assert ARCH_ID not in treg.list_archs()
    assert treg.all_archs() == treg.list_archs() + [ARCH_ID]
    assert treg.get_config(ARCH_ID) == full()
    assert treg.get_config(ARCH_ID, "smoke") == smoke()
    from repro_torch.launch.serve import _build_parser
    args = _build_parser().parse_args(["--arch", ARCH_ID, "--variant",
                                       "full"])
    assert args.arch == ARCH_ID


@pytest.mark.parametrize("pads", [(0, 0), (0, 3), (5, 1)],
                         ids=lambda p: f"pads{p[0]}-{p[1]}")
def test_prefill_then_decode_matches_the_reference(pads):
    cfg, lm, params = _model()
    ref_w = mref.from_program(params, cfg)
    S, steps = 12, 5
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(1, cfg.vocab_size, (len(pads), S + steps),
                         generator=g)
    for row, pad in enumerate(pads):
        toks[row, :pad] = 0                    # left padding, a real token
    cache = lm.init_cache(len(pads), 32, device=CPU)
    logits, cache = lm.prefill(params, toks[:, :S], cache)
    got = [logits[:, 0]]
    for t in range(S, S + steps - 1):
        logits, cache = lm.decode_step(params, toks[:, t:t + 1], cache)
        got.append(logits[:, 0])
    got = torch.stack(got, 1)
    assert cache["index"] == S + steps - 1
    for row in range(len(pads)):
        want = mref.logits(ref_w, cfg, toks[row, :S + steps - 1])[S - 1:]
        assert (_rel(got[row], want) < TOL).all(), _rel(got[row], want)
    full_logits, _ = lm.apply(params, toks[:, :S + steps - 1], remat="none")
    assert (_rel(got, full_logits[:, S - 1:]) < TOL).all()


def test_absorbed_decode_equals_expanded_attention():
    cfg, lm, params = _model()
    p = {k: v[0] for k, v in params["seg1_mla_moe"]["attn"].items()}
    B, S = 2, 9
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    lat_pre = torch.zeros(B, 16, cfg.latent_dim)
    want = mla.prefill(p, x, cfg, pos, lat_pre)
    lat = torch.zeros(B, 16, cfg.latent_dim)
    got = torch.cat([mla.decode(p, x[:, t:t + 1], lat, cfg, t)
                     for t in range(S)], dim=1)
    torch.testing.assert_close(lat, lat_pre, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [None, 12, 16])
def test_decode_at_a_masked_length_equals_the_exact_step(length):
    """`LM.decode_at` reading `length` cache positions with those past the
    written one masked (stale values there too) gives the exact step's
    logits and writes the same cache."""
    cfg, lm, params = _model()
    B, S = 2, 7
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(4))
    _, c_exact = lm.prefill(params, toks[:, :S], lm.init_cache(B, 16,
                                                                device=CPU))
    want, _ = lm.decode_step(params, toks[:, S:], c_exact)
    cache = lm.init_cache(B, 16, device=CPU)
    lm.prefill(params, toks[:, :S], cache)
    for name, c in cache.items():
        if name != "index":
            c["latent"][:, :, S + 1:] = 7.0
    pos = torch.tensor([S])
    at = (mla.DecodeAt.exact(S, CPU) if length is None
          else mla.DecodeAt.within(pos, length))
    got = lm.decode_at(params, toks[:, S:], cache, at)
    assert (_rel(got, want) < TOL).all()
    for name, c in cache.items():
        if name != "index":
            lat, ref = c["latent"], c_exact[name]["latent"]
            assert torch.equal(lat[:, :, :S], ref[:, :, :S])
            # past the first layer, the step's input carries the masked
            # attention's other order of sums
            torch.testing.assert_close(lat[:, :, S], ref[:, :, S],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_graphed_decode_gives_the_references_logits(monkeypatch):
    """On a CUDA device the engine replays its decode steps as CUDA graphs
    (a bucket of 16 cache positions here, so a wave crosses one): their
    logits are the reference's, every step's chosen experts reach the
    route log, and while a trace runs the graphs' tally counts every
    (token, expert) pair of the wave."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    from repro_torch.serve import engine as eng_mod
    monkeypatch.setattr(eng_mod, "GRAPH_BUCKET", 16)
    dev = torch.device("cuda")
    cfg, lm, params = _model(seed=9)
    ref_w = mref.from_program(params, cfg)
    params = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    seen = {}

    def hook(wave, step, logits):
        seen[(wave, step)] = logits[:, -1].cpu()

    eng = ServeEngine(lm, params, batch_slots=2, max_len=40, seed=1,
                      logits_hook=hook)
    prompts = [[5, 6, 7] * 3, [9] * 8, [3, 4], [11, 12, 13, 14, 15]]
    lm.route_log = log = []
    try:
        out = eng.generate(prompts, max_new_tokens=12)
    finally:
        lm.route_log = None
    assert sorted(eng._graphs.graphs) == [16, 32, 40]
    for i, (p, r) in enumerate(zip(prompts, out)):
        wave, slot = divmod(i, 2)
        pad = max(len(q) for q in prompts[2 * wave:2 * wave + 2]) - len(p)
        seq = torch.tensor([0] * pad + p + r.tokens[:-1])
        want = mref.logits(ref_w, cfg, seq)[pad + len(p) - 1:]
        got = torch.stack([seen[(wave, s)][slot] for s in range(12)])
        assert (_rel(got, want) < TOL).all()
        assert r.tokens == [int(t) for t in got.argmax(-1)]
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    assert len(log) == 2 * n_moe * (1 + 12)
    assert all(t.shape == (2, cfg.top_k) for t in log[n_moe:13 * n_moe])
    spans.drain_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    found, _ = spans.drain_spans()
    (wave,) = [s for s in found if s["name"] == "lm_wave"]
    pairs = (6 + 3 * 2) * cfg.top_k * n_moe
    assert wave["ids"]["expert_mean"] * cfg.n_experts == pairs


def test_routing_selects_with_the_bias_and_weights_without_it():
    cfg = dataclasses.replace(smoke(), n_experts=4, top_k=2)
    x = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    router = torch.zeros(4, 4)
    router[0] = torch.tensor([2.0, 1.0, 0.5, 0.0])
    bias = torch.tensor([0.0, 0.0, 0.5, 0.0])
    w, idx = moe.sigmoid_route(x, router, bias, cfg)
    # scores sigmoid(2, 1, .5, 0); the bias lifts expert 2 over expert 1
    assert idx.tolist() == [[2, 0]]
    s = torch.sigmoid(torch.tensor([0.5, 2.0]))
    torch.testing.assert_close(w[0], s / s.sum() * 2.446)
    assert abs(float(w.sum()) - 2.446) < 1e-6
    ref_w, ref_idx = mref.route({"router": router, "score_bias": bias}, x,
                                cfg)
    assert sorted(ref_idx[0].tolist()) == sorted(idx[0].tolist())
    torch.testing.assert_close(w.sort(-1).values, ref_w.sort(-1).values)
    # equal scores: the lower expert wins, as `top_k` breaks ties
    _, tie = moe.sigmoid_route(x, torch.zeros(4, 4), torch.zeros(4), cfg)
    assert tie.tolist() == [[0, 1]]


def _loop_experts(xt, w, idx, wg, wu, wd):
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(xt[t] @ wg[e]) * (xt[t] @ wu[e])
            out[t] += w[t, j] * (h @ wd[e])
    return out


@pytest.mark.parametrize("skew", [False, True], ids=["spread", "one-expert"])
def test_dropless_experts_compute_every_pair(skew):
    g = torch.Generator().manual_seed(4)
    T, K, E, D, F = 40, 3, 8, 16, 12
    xt = torch.randn(T, D, generator=g)
    idx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
    if skew:                 # every token picks experts 5, 6, 7: no capacity
        idx = torch.tensor([[5, 6, 7]]).repeat(T, 1)
    w = torch.rand(T, K, generator=g)
    wg, wu = torch.randn(E, D, F, generator=g), torch.randn(E, D, F,
                                                             generator=g)
    wd = torch.randn(E, F, D, generator=g)
    out, counts = moe.dropless_experts(xt, w, idx, wg, wu, wd)
    assert int(counts.sum()) == T * K
    assert counts.tolist() == torch.bincount(idx.flatten(),
                                             minlength=E).tolist()
    torch.testing.assert_close(out, _loop_experts(xt, w, idx, wg, wu, wd),
                               rtol=1e-5, atol=1e-4)


def test_bf16_experts_run_the_grouped_product():
    g = torch.Generator().manual_seed(5)
    T, K, E, D, F = 24, 2, 4, 64, 32
    xt = torch.randn(T, D, generator=g)
    idx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
    w = torch.rand(T, K, generator=g)
    ws = [torch.randn(E, D, F, generator=g) / 8,
          torch.randn(E, D, F, generator=g) / 8,
          torch.randn(E, F, D, generator=g) / 6]
    out, _ = moe.dropless_experts(xt.bfloat16(), w, idx,
                                  *[t.bfloat16() for t in ws])
    want = _loop_experts(xt.bfloat16().float(), w, idx,
                         *[t.bfloat16().float() for t in ws])
    assert out.dtype == torch.bfloat16
    assert float(_rel(out.float().flatten(), want.flatten())) < 2e-2


def test_routed_block_adds_the_shared_experts():
    cfg, lm, params = _model()
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["seg1_mla_moe"]["moe"].items()}
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    out, counts, chosen = moe.routed_block(p, x, cfg)
    assert chosen.shape == (14, cfg.top_k)
    want = mref.moe(p, x.reshape(14, -1), cfg).reshape(2, 7, -1)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert int(counts.sum()) == 14 * cfg.top_k
    shared = mref.swiglu(p["shared"], x.reshape(14, -1)).reshape(2, 7, -1)
    assert float((out - shared).abs().max()) > 1e-3   # routed part counts
    routed, _ = moe.dropless_experts(
        x.reshape(14, -1), *moe.sigmoid_route(x.reshape(14, -1), p["router"],
                                              p["score_bias"], cfg),
        p["w_gate"], p["w_up"], p["w_down"])
    torch.testing.assert_close(out.reshape(14, -1) - routed,
                               shared.reshape(14, -1), rtol=1e-5, atol=1e-5)


def test_engine_generates_through_prefill_with_the_references_logits(
        monkeypatch):
    cfg, lm, params = _model(seed=9)
    ref_w = mref.from_program(params, cfg)
    calls = []
    real = lm.prefill
    monkeypatch.setattr(lm, "prefill",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    seen = {}

    def hook(wave, step, logits):
        seen[(wave, step)] = logits[:, -1].clone()

    eng = ServeEngine(lm, params, batch_slots=2, max_len=40, seed=1,
                      logits_hook=hook)
    prompts = [[5, 6, 7], [9] * 8, [3, 4], [11, 12, 13, 14, 15]]
    out = eng.generate(prompts, max_new_tokens=4)
    assert calls == [(2, 8), (2, 5)]
    for i, (p, r) in enumerate(zip(prompts, out)):
        wave, slot = divmod(i, 2)
        pad = max(len(q) for q in prompts[2 * wave:2 * wave + 2]) - len(p)
        seq = torch.tensor([0] * pad + p + r.tokens[:-1])
        want = mref.logits(ref_w, cfg, seq)[pad + len(p) - 1:]
        got = torch.stack([seen[(wave, s)][slot] for s in range(4)])
        assert (_rel(got, want) < TOL).all()
        assert r.tokens == [int(t) for t in got.argmax(-1)]


def test_reference_archs_prefill_is_the_teacher_forced_loop():
    cfg = treg.get_config("kimi-k2-1t-a32b", "smoke")
    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(0, device=CPU), device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(3))
    got, c1 = lm.prefill(params, toks, lm.init_cache(2, 8, device=CPU))
    c2 = lm.init_cache(2, 8, device=CPU)
    for t in range(6):
        want, c2 = lm.decode_step(params, toks[:, t:t + 1], c2)
    assert torch.equal(got, want) and c1["index"] == c2["index"] == 6
    for k in ("k", "v"):
        assert torch.equal(c1["seg1_moe"][k], c2["seg1_moe"][k])


def test_wave_spans_and_expert_tally_while_tracing():
    cfg, lm, params = _model()
    eng = ServeEngine(lm, params, batch_slots=2, max_len=32, seed=1)
    spans.drain_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    found, dropped = spans.drain_spans()
    assert dropped == 0 and lm.expert_tally is None
    by = {}
    for s in found:
        by.setdefault(s["name"], []).append(s)
    (wave,), (pre,), (dec,) = by["lm_wave"], by["lm_prefill"], \
        by["lm_decode"]
    assert wave["ids"]["padded_tokens"] == 6 == pre["ids"]["tokens"]
    assert wave["ids"]["requests"] == 2 and wave["ids"]["prompt_tokens"] == 5
    assert dec["ids"]["steps"] == 3
    assert len(by["mla_attend"]) == cfg.n_layers * (1 + 3)
    # every (token, expert) pair of the wave: prefill's 6 tokens and 3
    # decode steps of 2 slots, top-k each, in each MoE layer
    pairs = (6 + 3 * 2) * cfg.top_k * (cfg.n_layers - cfg.n_dense_prefix)
    assert wave["ids"]["expert_mean"] * cfg.n_experts == pairs
    assert pairs / cfg.n_experts <= wave["ids"]["expert_busiest"] <= pairs
    # untraced: no span, no tally
    eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert spans.drain_spans() == ([], 0)


def test_static_analysis_covers_the_serving_steps(monkeypatch):
    from pathlib import Path

    from repro_torch.analysis import contracts as contracts_mod
    from repro_torch.analysis.registry import HOT_PATH_ROOTS, port_contracts
    from repro_torch.analysis.trace import TraceHygienePass, run_trace_pass

    names = [c.name for c in port_contracts()]
    assert names == [f"LM.prefill[{ARCH_ID}-smoke]",
                     f"LM.decode[{ARCH_ID}-smoke]"]
    assert all(c.run("cpu") is None for c in port_contracts())
    # the host-sync pass reaches the new paths and finds them clean...
    root = Path(__file__).resolve().parents[1]
    for file, fns in (("src/repro_torch/models/mla.py",
                       {"prefill", "decode", "_project", "_rope"}),
                      ("src/repro_torch/models/moe.py",
                       {"routed_block", "dropless_experts", "_grouped",
                        "sigmoid_route"}),
                      ("src/repro_torch/models/transformer.py",
                       {"LM.prefill", "LM._mla_layer"})):
        src = (root / file).read_text()
        p = TraceHygienePass(file, src, HOT_PATH_ROOTS[file])
        assert fns <= p.reachable(), fns - p.reachable()
        assert run_trace_pass(file, src, HOT_PATH_ROOTS[file]) == []
    # ...and would see a count brought to the host for the dispatch
    file = "src/repro_torch/models/moe.py"
    src = (root / file).read_text().replace(
        "offs = torch.cumsum(counts, 0)",
        "offs = torch.cumsum(counts.cpu(), 0)")
    assert [f.rule for f in run_trace_pass(file, src, HOT_PATH_ROOTS[file])
            ] == ["TRC102"]
    # a decode that loses a feature is caught by the contract pass
    real = mla.decode
    monkeypatch.setattr(mla, "decode", lambda *a: real(*a)[..., 1:])
    monkeypatch.setattr(contracts_mod, "shape_contracts", lambda: [])
    found = [f for f in contracts_mod.run_contract_pass(device="cpu")
             if f.rule != "SHP003"]        # the detector's, emptied here
    assert [f.rule for f in found] == ["SHP001"]
    assert f"LM.decode[{ARCH_ID}-smoke]" in found[0].message
