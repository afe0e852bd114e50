"""The port's LM serving path against the JAX package's on the CPU, at
phi3-medium-14b's smoke config: `ServeEngine`'s greedy and sampled
(temperature 0.8) tokens equal to the JAX engine's step by step until the
first step where the reference's top-2 gap is under 1e-4 (such near-ties
are counted and printed; past one, that slot is not compared), EOS and
prompt order, the wave-independence of sampling keys, `prng.randint`,
`gumbel` and `categorical` bit for bit under both threefry schemes, and
the serving CLI: its prompts and printed tokens equal to the JAX CLI's,
its flag refusals, the card as its default device, and `--ckpt-dir`
restoring a checkpoint the JAX package wrote (params-only and training
layouts)."""
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_pytree as jsave
from repro.configs.registry import get_config as jget
from repro.launch import serve as jcli
from repro.models import LM as JLM
from repro.serve import ServeEngine as JEngine
from repro_torch import prng
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tcli
from repro_torch.models.transformer import LM as TLM
from repro_torch.serve import ServeEngine as TEngine

ARCH = "phi3-medium-14b"
NEAR_TIE = 1e-4
PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [11, 12]]


@functools.lru_cache(maxsize=None)
def _models():
    jlm = JLM(jget(ARCH, "smoke"))
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tget(ARCH, "smoke"))
    return jlm, jp, tlm, lm_params_from_jax(jax.device_get(jp), "cpu")


def _record(engine, rows, to_np):
    """Wrap `engine._sample` so each call records (wave, step, last-token
    logits, sampled tokens)."""
    inner = engine._sample

    def sample(logits, *, wave, step):
        out = inner(logits, wave=wave, step=step)
        rows.append((wave, step, to_np(logits)[:, -1, :], np.array(out)))
        return out
    engine._sample = sample


def _gap(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)
    return top[:, -1] - top[:, -2]


def _compare(ref_rows, got_rows, ref_scores):
    """Tokens equal per (wave, step, slot) until the reference's top-2 gap
    of its sampled scores falls under NEAR_TIE; returns (compared, near-
    ties)."""
    assert [(w, s) for w, s, _, _ in ref_rows] == \
        [(w, s) for w, s, _, _ in got_rows]
    stopped, compared, ties = set(), 0, 0
    for (w, s, lg, rt), (_, _, glg, gt) in zip(ref_rows, got_rows):
        np.testing.assert_allclose(glg, lg, atol=1e-5, rtol=1e-4)
        gap = _gap(ref_scores(w, s, lg))
        for slot in range(len(rt)):
            if (w, slot) in stopped:
                continue
            if gap[slot] < NEAR_TIE:
                ties += 1
                stopped.add((w, slot))
                continue
            assert gt[slot] == rt[slot], (w, s, slot)
            compared += 1
    return compared, ties


@pytest.mark.parametrize("temperature,eos", [(0.0, None), (0.0, 86),
                                             (0.8, None)])
def test_engine_tokens_equal_reference(temperature, eos):
    jlm, jp, tlm, tp = _models()
    kw = dict(batch_slots=2, max_len=32, eos_id=eos,
              temperature=temperature, seed=5)
    ref_eng, got_eng = JEngine(jlm, jp, **kw), TEngine(tlm, tp, **kw)
    ref_rows, got_rows = [], []
    _record(ref_eng, ref_rows, np.asarray)
    _record(got_eng, got_rows, lambda t: t.numpy())
    ref = ref_eng.generate(PROMPTS, max_new_tokens=8)
    got = got_eng.generate(PROMPTS, max_new_tokens=8)

    def scores(wave, step, lg):
        if temperature == 0:
            return lg
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5),
                                                  wave), step)
        return np.asarray(jax.random.gumbel(k, lg.shape)) + lg / np.float32(
            temperature)

    compared, ties = _compare(ref_rows, got_rows, scores)
    print(f"temperature {temperature}, eos {eos}: {compared} tokens "
          f"compared, {ties} near-ties")
    assert compared > 0
    assert [r.prompt for r in got] == PROMPTS
    if ties == 0:
        assert [(r.tokens, r.finished) for r in got] == \
            [(r.tokens, r.finished) for r in ref]
    if eos is not None:
        assert any(r.finished for r in got)
        for r in got:
            assert r.finished == (eos in r.tokens)
            assert eos not in r.tokens[:-1]


def test_engine_stats_and_run_log(tmp_path):
    from repro_torch.obs import RunLog
    _, _, tlm, tp = _models()
    obs = RunLog.create("serve-test", root=str(tmp_path), run_id="r")
    eng = TEngine(tlm, tp, batch_slots=2, max_len=32, obs=obs)
    out = eng.generate(PROMPTS, max_new_tokens=4)
    assert [len(r.tokens) for r in out] == [4] * len(PROMPTS)
    st = eng.stats()
    assert st["prefill"]["laps"] == st["decode"]["laps"] == 3
    assert st["decode"]["tokens"] == 4 * len(PROMPTS)
    eng.log_stats()
    obs.finalize()
    kinds = [json.loads(line)["kind"] for line in
             (tmp_path / "r" / "metrics.jsonl").read_text().splitlines()]
    assert kinds.count("serve_wave") == 3 and kinds.count("phase") == 2
    with pytest.raises(ValueError):
        eng.generate([[1] * 30], max_new_tokens=4)


def test_sampling_independent_of_earlier_waves():
    """Keys are fold_in(root, wave, step): wave 1's draws do not change
    when wave 0 generates a different number of tokens (the reference's
    `tests/test_train_stack.py` property)."""
    _, _, tlm, tp = _models()

    def second_wave_tokens(first_wave_len: int):
        eng = TEngine(tlm, tp, batch_slots=1, max_len=32, temperature=1.0,
                      seed=7)
        eng.generate([[1, 2]], max_new_tokens=first_wave_len)
        return eng.generate([[3, 4, 5]], max_new_tokens=6)[0].tokens

    assert second_wave_tokens(2) == second_wave_tokens(9)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def scheme(request):
    with jax.threefry_partitionable(request.param), \
            prng.threefry_partitionable(request.param):
        yield request.param


@pytest.mark.parametrize("lo,hi", [(0, 128), (0, 100352), (-7, 9), (3, 3),
                                   (0, 2**31 - 1), (-2**31, 2**31 - 1),
                                   (0, 65536), (0, 65537)])
def test_randint_bit_identical(scheme, lo, hi):
    for seed in (0, 1, 11):
        for shape in ((7,), (3, 5)):
            ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                                shape, lo, hi))
            got = prng.randint(prng.PRNGKey(seed, device="cpu"), shape, lo,
                               hi)
            assert got.dtype == torch.int32
            assert np.array_equal(ref, got.numpy()), (seed, shape)


def test_gumbel_and_categorical_bit_identical(scheme):
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.gumbel(key, (16, 1000)))
        got = prng.gumbel(prng.PRNGKey(seed, device="cpu"), (16, 1000))
        assert np.array_equal(ref.view(np.uint32),
                              got.numpy().view(np.uint32))
        logits = np.random.default_rng(seed).normal(size=(8, 300)).astype(
            np.float32)
        ref = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
        got = prng.categorical(prng.PRNGKey(seed, device="cpu"),
                               torch.from_numpy(logits))
        assert np.array_equal(ref, got.numpy())
    with pytest.raises(ValueError):
        prng.categorical(prng.PRNGKey(0, device="cpu"),
                         torch.zeros(2, 3, dtype=torch.float64))


def _ref_cli_prompts(n, vocab):
    """The JAX CLI's prompt loop (`repro/launch/serve.py`)."""
    rng = jax.random.PRNGKey(1)
    prompts = []
    for i in range(n):
        rng, k = jax.random.split(rng)
        prompts.append([int(t) for t in jax.random.randint(
            k, (2 + i % 6,), 0, vocab)])
    return prompts


@pytest.mark.parametrize("vocab", [128, 100352])
def test_cli_prompts_equal(vocab):
    assert tcli.lm_prompts(9, vocab, "cpu") == _ref_cli_prompts(9, vocab)


def _run(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main()
    return capsys.readouterr().out.splitlines()


def _req_lines(lines):
    return [l for l in lines if l.startswith(("req ", "restored step"))]


def test_cli_tokens_equal_reference(capsys, monkeypatch, tmp_path):
    argv = ["--requests", "5", "--slots", "2", "--max-new", "6"]
    ref = _run(jcli.main, argv, capsys, monkeypatch)
    got = _run(tcli.main, argv + ["--device", "cpu", "--run-dir",
                                  str(tmp_path), "--run-id", "lm"],
               capsys, monkeypatch)
    assert _req_lines(got) == _req_lines(ref) and len(_req_lines(ref)) == 4
    stats = json.loads(next(l for l in got if l.startswith("# lm stats"))
                       [len("# lm stats "):])
    assert stats["requests"] == 5 and stats["new_tokens"] == 30
    assert stats["in_vocab"] and stats["logits_finite"]
    assert {p.name for p in (tmp_path / "lm").iterdir()} >= \
        {"manifest.json", "metrics.jsonl"}
    man = json.loads((tmp_path / "lm" / "manifest.json").read_text())
    assert man["name"] == f"serve-{ARCH}"


def test_cli_flag_refusals_and_default_device(capsys, monkeypatch):
    for argv in (["--committee", "3"], ["--det-backend", "kernel"],
                 ["--network", "detector", "--arch", "rwkv6-3b"],
                 ["--network", "detector", "--temperature", "0.5"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv + ["--device", "cpu"])
        assert e.value.code == 2, argv
        assert "only applies to" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--requests", "1"])


@pytest.mark.parametrize("layout", ["params", "train"])
def test_cli_restores_jax_checkpoint(capsys, monkeypatch, tmp_path, layout):
    """--ckpt-dir of a checkpoint the JAX package wrote (params-only, or a
    training tree under `params/`): both CLIs print `restored step 7` and
    the same tokens, which differ from the unrestored init's."""
    jlm, jp, _, _ = _models()
    other = JLM(jget(ARCH, "smoke")).init(jax.random.PRNGKey(3))
    tree = other if layout == "params" else {
        "params": other, "step": jnp.asarray(7, jnp.int32)}
    jsave(tree, tmp_path, step=7)
    argv = ["--requests", "4", "--slots", "2", "--max-new", "5",
            "--ckpt-dir", str(tmp_path)]
    ref = _run(jcli.main, argv, capsys, monkeypatch)
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys, monkeypatch)
    assert f"restored step 7 from {tmp_path}" in got
    assert _req_lines(got) == _req_lines(ref)
    plain = _run(tcli.main, argv[:-2] + ["--device", "cpu"], capsys,
                 monkeypatch)
    assert _req_lines(plain) != _req_lines(got)[1:]


@pytest.mark.parametrize("partitionable", [True, False])
def test_smoke_threefry_window(partitionable):
    """chip_smoke's plain words of a counter window equal the plain draw's
    slice, at odd and even sizes, windows at each place it takes them."""
    from torch_smoke_loader import chip_smoke
    smoke = chip_smoke()
    key = prng.PRNGKey(42, device="cpu")
    with prng.threefry_partitionable(partitionable):
        for n in (1, 7, 8, 1001):
            full = prng.random_bits_plain(key, (n,))
            wins = smoke.lm_windows(n, partitionable, w=4)
            assert wins[0] == (0, min(4, n))
            for a, b in wins + [(0, n)]:
                assert torch.equal(
                    smoke.threefry_window(key, n, a, b, partitionable),
                    full[a:b]), (n, a, b)


def test_smoke_lm_helpers():
    from torch_smoke_loader import chip_smoke
    smoke = chip_smoke()
    n = 40 * 5120 * 17920
    wins = smoke.lm_windows(n, True)
    assert wins == [(0, 1 << 20), ((1 << 31) - (1 << 19), (1 << 31)
                                   + (1 << 19)), (n - (1 << 20), n)]
    assert len(smoke.lm_windows(n, False)) == 4
    assert smoke.lm_samples(8, 4, 16) == 34
    assert smoke.lm_samples(5, 2, 6) == 21
    b = smoke.lm_decode_bound(tget(ARCH, "full"), 4)
    # every bf16 weight once (the analytic count lacks the final norm's
    # 5120), the embedding's 4 gathered rows only
    want = (tget(ARCH, "full").param_count() + 5120 - 100352 * 5120
            + 4 * 5120) * 2
    assert b["bytes"] == want
    assert b["ms"] == pytest.approx(want / 3.35e12 * 1e3)
    lines = ["req 0: 2 prompt toks -> [1]...",
             '# kernel launches {"threefry": 3} by tail {"uniform": 1}',
             '# lm stats {"requests": 1, "tokens": [[1]]}']
    assert smoke.lm_cli_stats(lines) == {
        "launches": {"threefry": 3}, "tail_launches": {"uniform": 1},
        "requests": 1, "tokens": [[1]]}
    gaps = [[1.0, 1.0], [1.0, 1e-6], [1.0, 1.0]]
    assert smoke.lm_tokens_agree([[1, 2], [3, 4]], [[1, 2], [3, 5]], gaps,
                                 2, 2) == (3, 1, 0)
    assert smoke.lm_tokens_agree([[1, 9]], [[1, 2]], gaps, 2, 2) == (2, 0, 1)
