"""The port's `Trainer`, `launch.train` and LM examples against the JAX
package's, on the CPU at smoke configs.

  * Within the port, 6 straight steps equal 3 steps, a resume from the
    checkpoint, then 3 more, bit for bit (the losses and the final state).
  * Across packages, a checkpoint written by either `Trainer` resumes in
    the other's (the same on-disk format and key paths): the resumed
    losses agree with the writer's straight run within atol 1e-5 +
    rtol 1e-4 (float32 in other summation orders, three AdamW steps in).
  * keep-k garbage collection, async saves on a background thread and the
    final save; one straggler caught with the timer's clock patched.
  * `launch.train --device cpu` against the JAX CLI (run in a subprocess
    with one JAX device, as the CLI runs on a host): the same run-dir
    files, event kinds in order and field names per kind, losses within
    the bar above, the last line's wording; `--mesh single` refused.
  * The examples' `main()` against the JAX scripts, loaded from their
    files with `sys.argv` patched: `train_lm`'s lines (losses within the
    bar), `serve_lm`'s prompts and tokens equal.
"""
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.lm import SyntheticLMData as TData  # noqa: E402
from repro_torch.examples import serve_lm as tserve  # noqa: E402
from repro_torch.examples import train_lm as ttrain  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.common import tree_leaves_with_path  # noqa: E402
from repro_torch.models.transformer import LM as TLM  # noqa: E402
from repro_torch.obs import timers  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

from torch_smoke_loader import chip_smoke  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "phi3-medium-14b"
ATOL, RTOL = 1e-5, 1e-4
LR = 1e-3
STEPS = 6


def _data(cls, cfg):
    return cls(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)


def _port_trainer(ckpt_dir, total, ckpt_every=3, keep=3, obs=None):
    lm = TLM(treg.get_config(ARCH, "smoke"))
    data = _data(TData, lm.cfg)
    state = tsteps.init_train_state(lm, prng.PRNGKey(0, device="cpu"),
                                    device="cpu")
    step = tsteps.make_train_step(
        lm, lr_fn=lambda s: torch.tensor(LR, dtype=torch.float32))
    return ttrainer.Trainer(
        ttrainer.TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                               ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                               keep_ckpts=keep, log_every=1),
        step, lambda s: data.batch_for_step(s, device="cpu"), state, obs=obs)


def _jax_trainer(ckpt_dir, total, ckpt_every=3):
    lm = JLM(jreg.get_config(ARCH, "smoke"))
    data = _data(JData, lm.cfg)
    state = jsteps.init_train_state(lm, jax.random.PRNGKey(0))
    step = jsteps.make_train_step(lm, lr_fn=lambda s: jnp.float32(LR))
    return jtrainer.Trainer(
        jtrainer.TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                               ckpt_dir=str(ckpt_dir), log_every=1),
        step, lambda s: data.batch_for_step(s), state)


def _losses(hist):
    return [h["loss"] for h in hist]


def test_resume_is_exact_within_the_port(tmp_path):
    straight = _port_trainer(None, STEPS)
    full = straight.run()
    first = _port_trainer(tmp_path, 3).run()
    resumed = _port_trainer(tmp_path, STEPS)
    rest = resumed.run()
    assert [h["step"] for h in rest] == [3, 4, 5]
    assert _losses(first + rest) == _losses(full)
    for (p, a), (_, b) in zip(tree_leaves_with_path(straight.state),
                              tree_leaves_with_path(resumed.state)):
        assert torch.equal(a, b), p
    assert sorted(full[0]) == sorted(
        ["grad_norm", "loss", "lr", "moe_aux_loss", "nll", "z_loss", "step",
         "step_time_s"])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's straight 6 steps, checkpoints at 3 and 6."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    return d, _jax_trainer(d, STEPS).run()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's Trainer: straight 6 steps, checkpoints at 3 and 6."""
    d = tmp_path_factory.mktemp("port_ckpt")
    return d, _port_trainer(d, STEPS).run()


def _step3_only(src: Path, dst: Path) -> Path:
    dst.mkdir()
    shutil.copytree(src / "step_000000003", dst / "step_000000003")
    return dst


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    d, ref = jax_run
    got = _port_trainer(_step3_only(d, tmp_path / "c"), STEPS).run()
    assert [h["step"] for h in got] == [3, 4, 5]
    np.testing.assert_allclose(_losses(got), _losses(ref[3:]), atol=ATOL,
                               rtol=RTOL)


def test_port_checkpoint_resumes_in_jax(port_run, jax_run, tmp_path):
    d, ours = port_run
    got = _jax_trainer(_step3_only(d, tmp_path / "c"), STEPS).run()
    assert [h["step"] for h in got] == [3, 4, 5]
    np.testing.assert_allclose(_losses(got), _losses(ours[3:]), atol=ATOL,
                               rtol=RTOL)
    # the two packages' straight runs agree too
    np.testing.assert_allclose(_losses(ours), _losses(jax_run[1]),
                               atol=ATOL, rtol=RTOL)
    meta = json.loads((d / "step_000000006" / "META.json").read_text())
    assert "opt/m/embed" in meta["keys"] and "opt/step" in meta["keys"]
    assert "step" in meta["keys"] and "params/embed" in meta["keys"]


def _writes_on(monkeypatch):
    """Record (step, thread name) of every checkpoint write."""
    inner = tckpt.save_pytree
    seen = []

    def save(tree, directory, step, *a, **k):
        seen.append((step, threading.current_thread().name))
        return inner(tree, directory, step, *a, **k)
    monkeypatch.setattr(tckpt, "save_pytree", save)
    return seen


def test_keep_k_async_and_final_save(tmp_path, monkeypatch):
    seen = _writes_on(monkeypatch)
    tr = _port_trainer(tmp_path / "a", 5, ckpt_every=1, keep=2)
    tr.run()
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_000000004", "step_000000005"]
    assert [s for s, _ in seen] == [1, 2, 3, 4, 5]
    main = threading.main_thread().name
    assert all(name != main for _, name in seen), seen
    assert tr.ckpt.saved_steps == [1, 2, 3, 4, 5]
    seen.clear()
    _port_trainer(tmp_path / "b", 5, ckpt_every=2).run()
    # async saves at 2 and 4, then the missing final save at 5, in line
    assert [s for s, _ in seen] == [2, 4, 5]
    assert seen[-1][1] == main and seen[0][1] != main
    assert tckpt.latest_step(tmp_path / "b") == 5


class _Clock:
    """`time.perf_counter` for the timer: lap i lasts durations[i]."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.t = 0.0
        self.calls = 0

    def perf_counter(self):
        if self.calls % 2:
            self.t += self.durations[self.calls // 2]
        self.calls += 1
        return self.t


def test_straggler_watchdog(monkeypatch, capsys):
    monkeypatch.setattr(timers, "time",
                        _Clock([5.0] + [1.0] * 6 + [4.0, 1.0, 2.9]))
    tr = _port_trainer(None, 10)
    hist = tr.run()
    # step 7 lasts 4 s against a median of 1 s; the first step's 5 s comes
    # before 5 steps are known, and step 9's 2.9 s is under 3x the median
    assert tr.straggler_steps == [7]
    assert [h["step_time_s"] for h in hist] == pytest.approx(
        [5.0] + [1.0] * 6 + [4.0, 1.0, 2.9])
    assert tr.step_timer.compile_s == 5.0
    out = capsys.readouterr().out
    assert "step     7 loss" in out and "(4000 ms)" in out


def _events(run_dir: Path):
    return [json.loads(l) for l in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


LAST = re.compile(r"final loss (\S+) over (\d+) steps \(resumed at (\d+)\); "
                  r"stragglers: (\d+); compile (\S+)s, (\S+) steps/s steady")


def test_train_cli_matches_the_jax_cli(tmp_path, capsys):
    argv = ["--steps", "4", "--batch", "2", "--seq", "16", "--remat",
            "block", "--microbatch", "2", "--run-dir", str(tmp_path)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *argv, "--run-id", "j",
         "--ckpt-dir", str(tmp_path / "jck")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = proc.stdout.strip().splitlines()
    tlaunch.main([*argv, "--run-id", "t", "--ckpt-dir", str(tmp_path / "tck"),
                  "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    ev_t, ev_j = _events(tmp_path / "t"), _events(tmp_path / "j")
    assert [e["kind"] for e in ev_t] == [e["kind"] for e in ev_j]
    for a, b in zip(ev_t, ev_j):
        assert sorted(a) == sorted(b), a["kind"]
    steps_t = [e for e in ev_t if e["kind"] == "train_step"]
    steps_j = [e for e in ev_j if e["kind"] == "train_step"]
    np.testing.assert_allclose([e["loss"] for e in steps_t],
                               [e["loss"] for e in steps_j], atol=ATOL,
                               rtol=RTOL)
    mt, mj = (LAST.fullmatch(got[-1]), LAST.fullmatch(want[-1]))
    assert mt and mj, (got[-1], want[-1])
    np.testing.assert_allclose(float(mt[1]), float(mj[1]), atol=1e-4)
    assert mt.groups()[1:4] == mj.groups()[1:4]
    # the port's step lines are the reference's, up to the losses' digits
    shape = lambda lines: [re.sub(r"[\d.]+", "#", l) for l in lines
                           if l.startswith("step ")]
    assert shape(got) == shape(want)
    stats = json.loads(next(l for l in got if l.startswith("# train stats"))
                       [len("# train stats "):])
    assert stats["steps"] == 4 and stats["tokens_per_step"] == 32
    manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert manifest["status"] == "ok" and manifest["name"] == \
        "train-hymba-1.5b"


def test_train_cli_refuses_the_production_mesh():
    for kind, chips in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit, match=f"{chips}-chip production"):
            tlaunch.main(["--mesh", kind, "--device", "cpu", "--ckpt-dir",
                          ""])


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    mod.main()
    return capsys.readouterr().out.strip().splitlines()


def test_train_lm_example_matches_the_jax_script(tmp_path, monkeypatch,
                                                 capsys):
    ref = _load("train_lm")
    for size in ("small", "100m"):
        a, b = vars(ttrain.size_config(size)), vars(ref.size_config(size))
        assert {k: v for k, v in a.items() if k != "irc"} == {
            k: v for k, v in b.items() if k != "irc"}
        assert vars(a["irc"]) == vars(b["irc"])
    nums = lambda lines: [float(x) for l in lines for x in re.findall(
        r"(?:loss |first10=|last10=)(-?[\d.]+)", l)]
    # four steps; and one with --irc, whose ternary thresholds let two runs
    # part within a few steps once a near-zero gradient's sign differs
    for extra, steps in (([], 4), (["--irc"], 1)):
        argv = ["--arch", "hymba-1.5b", *extra, "--steps", str(steps),
                "--batch", "2", "--seq", "16"]
        want = _run_reference(
            ref, [*argv, "--ckpt-dir", str(tmp_path / f"j{steps}")],
            monkeypatch, capsys)
        res = ttrain.main([*argv, "--ckpt-dir", str(tmp_path / f"t{steps}"),
                           "--device", "cpu"])
        got = capsys.readouterr().out.strip().splitlines()
        assert got[0] == want[0]        # the model line
        np.testing.assert_allclose(nums(got), nums(want), atol=ATOL,
                                   rtol=RTOL)
        assert len(res["history"]) == steps and res["params"] == 182480
        assert tckpt.latest_step(tmp_path / f"t{steps}") == steps


def test_serve_lm_example_matches_the_jax_script(monkeypatch, capsys):
    ref = _load("serve_lm")
    argv = ["--requests", "4", "--max-new", "5"]
    want = _run_reference(ref, argv, monkeypatch, capsys)
    results = tserve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert [l for l in got if l.startswith("req ")] == [
        l for l in want if l.startswith("req ")]
    assert len(results) == 4
    prompts = tserve.prompts_for(4, treg.get_config(
        "phi3-medium-14b", "smoke").vocab_size, "cpu")
    assert [r.prompt for r in results] == prompts
    assert [len(p) for p in prompts] == [3, 4, 5, 6]


def test_chip_smoke_train_helpers():
    smoke = chip_smoke()
    assert smoke.train_flops_share(1e9, 1000, 6e-3) == pytest.approx(
        1e15 / smoke.PEAK_BF16_FLOPS)
    lines = ["step     0 loss 1.0000 (5 ms)",
             '# train stats {"steps": 1, "losses": [1.0]}',
             '# kernel launches {"threefry": 3, "xla_fma": 0} by tail '
             '{"normal": 2}',
             "final loss 1.0000 over 1 steps (resumed at 0); stragglers: 0; "
             "compile 0.0s, 1.00 steps/s steady"]
    st = smoke.train_stats(lines)
    assert st["steps"] == 1 and st["launches"]["threefry"] == 3
    assert st["tail_launches"] == {"normal": 2}
    assert st["last"].startswith("final loss")
    assert "train_lm" in smoke.PHASES
    # the timed run saves nothing; the resume writes 2 full-width
    # checkpoints (the CLI saves every steps // 4 steps)
    assert smoke.TRAIN_LM_STEPS == 8
    first, then = smoke.TRAIN_LM_RESUME_STEPS
    assert first == max(first // 4, 1) and then - first == max(then // 4, 1)
    for name, group in (("nvjet_tst_128x", "matmul"), ("_Fma", "xla_fma"),
                        ("void at::native::(anonymous namespace)::"
                         "CatArrayBatchedCopy<", "copy"),
                        ("void at::native::scatter_gather_elementwise_"
                         "kernel<", "elementwise"),
                        ("cunn_SoftMaxForwardReg<float", "softmax")):
        assert smoke.train_kernel_group(name) == group
