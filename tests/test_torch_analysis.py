"""`repro_torch.analysis` against the JAX package's `repro.analysis`.

Every per-rule fixture of `tests/test_analysis.py` is a template that
renders in both idioms (`jax.random` / `repro_torch.prng`, `jnp` / `torch`,
`@jax.jit` / a declared hot-path root on a comment line, so the lines
agree); both packages' passes must give the same rule IDs at the same
lines.  The `static_argnames` half of TRC103 has no eager counterpart: its
port-side case is `custom_op(..., mutates_args=...)`.  Beside them: the
port-only rule cases, the baseline format read by both packages, the roots
and contracts against the reference's (each a twin or a `NO_TWIN` entry),
the contract pass on fake CPU tensors, the CLI's exit codes, and the fake
kernel ops (shapes equal to the plain versions'; the custom ops entered
only under a dispatch mode)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.analysis as ref_analysis  # noqa: E402
from repro.analysis.keys import run_key_pass as ref_key_pass  # noqa: E402
from repro.analysis.trace import (TraceHygienePass as RefTracePass,  # noqa: E402
                                  run_trace_pass as ref_trace_pass)
from repro_torch import prng  # noqa: E402
from repro_torch.analysis import (DEFAULT_BASELINE, Finding,  # noqa: E402
                                  assert_clean_subtrees, load_baseline,
                                  split_by_baseline, write_baseline)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import contracts as contracts_mod  # noqa: E402
from repro_torch.analysis.keys import run_key_pass  # noqa: E402
from repro_torch.analysis.registry import (HOT_PATH_ROOTS, NO_TWIN,  # noqa: E402
                                           ShapeContract, _expect, port_root,
                                           shape_contracts)
from repro_torch.analysis.trace import (TraceHygienePass,  # noqa: E402
                                        run_trace_pass)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.irc_mvm import TILES  # noqa: E402
from repro_torch.kernels.ref import IrcEpilogueParams  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

JAX = dict(imp="import jax", R="jax.random", alias="import jax.random as jr",
           mod="import jax", tns="import jax.numpy as jnp", T="jnp",
           root="@jax.jit")
PORT = dict(imp="from repro_torch import prng", R="prng",
            alias="import repro_torch.prng as jr", mod="import torch",
            tns="import torch", T="torch", root="# hot-path root")


def render(template: str, idiom: dict) -> str:
    return textwrap.dedent(template).format(**idiom)


def rules(findings):
    return [f.rule for f in findings]


def located(findings):
    return sorted((f.line, f.rule) for f in findings)


# --------------------------------------------------------------- KEY rules

KEY_CASES = {
    "key001_double_consumption": ("""
        {imp}
        def f(key, shape):
            a = {R}.normal(key, shape)
            b = {R}.uniform(key, shape)
            return a + b
    """, ["KEY001"]),
    "key001_clean_after_split": ("""
        {imp}
        def f(key, shape):
            k1, k2 = {R}.split(key)
            return {R}.normal(k1, shape) + \\
                {R}.uniform(k2, shape)
    """, []),
    "key001_rebinding_resets": ("""
        {imp}
        def f(key, shape):
            a = {R}.normal(key, shape)
            key = {R}.fold_in(key, 1)
            return a + {R}.normal(key, shape)
    """, []),
    "key001_exclusive_branches_not_flagged": ("""
        {imp}
        def f(key, shape, flag):
            if flag:
                return {R}.normal(key, shape)
            else:
                return {R}.uniform(key, shape)
    """, []),
    "key001_loop_reuse": ("""
        {imp}
        def f(key, xs):
            acc = []
            for x in xs:
                acc.append({R}.normal(key, x.shape))
            return acc
    """, ["KEY001"]),
    "key001_loop_fold_in_clean": ("""
        {imp}
        def f(key, xs):
            acc = []
            for i, x in enumerate(xs):
                k = {R}.fold_in(key, i)
                acc.append({R}.normal(k, x.shape))
            return acc
    """, []),
    "key001_sees_through_import_alias": ("""
        {alias}
        def f(key, shape):
            return jr.normal(key, shape) + jr.normal(key, shape)
    """, ["KEY001"]),
    "key002_wall_clock_key": ("""
        import time
        {imp}
        def f():
            return {R}.PRNGKey(int(time.time()))
    """, ["KEY002"]),
    "key002_np_random_fold": ("""
        {imp}
        import numpy as np
        def f(key):
            return {R}.fold_in(key, np.random.randint(1 << 20))
    """, ["KEY002"]),
    "key002_seeded_root_clean": ("""
        {imp}
        def f(seed):
            return {R}.PRNGKey(seed)
    """, []),
    "key003_constant_collision": ("""
        {imp}
        def f(key):
            a = {R}.fold_in(key, 3)
            b = {R}.fold_in(key, 3)
            return a, b
    """, ["KEY003"]),
    "key003_distinct_salts_clean": ("""
        {imp}
        def f(key):
            return {R}.fold_in(key, 1), {R}.fold_in(key, 2)
    """, []),
    "key003_undeclared_lattice": ("""
        {imp}
        def f(key, s, b):
            return {R}.fold_in(key, s * 7 + b)
    """, ["KEY003"]),
    "key003_declared_lattice_clean": ("""
        {imp}
        def f(key, s, b):
            return {R}.fold_in(key, s * 10 + b)
    """, []),
    "key004_mutable_key_state": ("""
        {imp}
        class Engine:
            def sample(self, logits):
                self.key, k = {R}.split(self.key)
                return {R}.categorical(k, logits)
    """, ["KEY004"]),
    "key004_stateless_fold_clean": ("""
        {imp}
        class Engine:
            def sample(self, logits, wave, step):
                k = {R}.fold_in(
                    {R}.fold_in(self.root, wave), step)
                return {R}.categorical(k, logits)
    """, []),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_key_rule_matches_reference(case):
    """Both packages flag the same rules at the same lines; the port's are
    the reference test's expectation."""
    template, want = KEY_CASES[case]
    ref = ref_key_pass("fixture.py", render(template, JAX))
    got = run_key_pass("fixture.py", render(template, PORT))
    assert rules(got) == want
    assert located(got) == located(ref)
    if case == "key001_loop_reuse":
        assert "every iteration replays" in got[0].message


PORT_KEY_CASES = {
    # the kernel wrapper and the plain twin consume a key as prng's draws do
    "wrapper_and_plain_twin_consume": ("""
        from repro_torch import prng
        from repro_torch.kernels import ops
        def f(key, shape):
            a = ops.threefry_draw(key, shape, "normal")
            b = prng.bernoulli_plain(key, 0.5, shape)
            return a, b
    """, [("KEY001", 6)]),
    "wrapper_fold_in_derives": ("""
        from repro_torch import prng
        from repro_torch.kernels import ops
        def f(key, shape):
            a = prng.normal(ops.threefry_fold_in(key, 1), shape)
            k = ops.threefry_split(key)
            return a, prng.normal(k[0], shape)
    """, []),
    "torch_global_rng_key": ("""
        import torch
        from repro_torch import prng
        def f(key):
            a = prng.PRNGKey(int(torch.randint(0, 1 << 20, ())))
            return a, prng.fold_in(key, torch.seed())
    """, [("KEY002", 5), ("KEY002", 6)]),
    "torch_seeded_generator_clean": ("""
        import torch
        from repro_torch import prng
        def f(seed):
            return prng.fold_in(prng.PRNGKey(seed), 3)
    """, []),
}


@pytest.mark.parametrize("case", sorted(PORT_KEY_CASES))
def test_port_key_rules(case):
    """Port-only spellings: the `ops.threefry_*` wrappers and the `*_plain`
    twins count as the prng functions they compute; torch's global RNG is
    a nondeterministic source."""
    template, want = PORT_KEY_CASES[case]
    got = run_key_pass("fixture.py", textwrap.dedent(template))
    assert located(got) == sorted((line, rule) for rule, line in want)


# --------------------------------------------------------------- TRC rules

TRACE_CASES = {
    "trc101_tracer_branch": ("""
        {mod}
        {tns}
        {root}
        def f(x):
            if {T}.sum(x) > 0:
                return x
            return -x
    """, {"f"}, ["TRC101"]),
    "trc101_where_clean": ("""
        {mod}
        {tns}
        {root}
        def f(x):
            return {T}.where({T}.sum(x) > 0, x, -x)
    """, {"f"}, []),
    "trc101_static_python_branch_clean": ("""
        {mod}
        {root}
        def f(x, per_chip):
            if per_chip:
                return x
            return -x
    """, {"f"}, []),
    "trc101_unreachable_not_flagged": ("""
        {tns}
        def f(x):
            if {T}.sum(x) > 0:
                return x
            return -x
    """, None, []),
    "trc101_transitive_callee": ("""
        {mod}
        {tns}
        def helper(x):
            while {T}.max(x) > 1:
                x = x * 0.5
            return x
        {root}
        def f(x):
            return helper(x)
    """, {"f"}, ["TRC101"]),
    "trc102_item_and_numpy": ("""
        {mod}
        import numpy as np
        {root}
        def f(x):
            y = x.item()
            return np.asarray(x) + y
    """, {"f"}, ["TRC102", "TRC102"]),
    "trc103_mutable_default": ("""
        {mod}
        {root}
        def f(x, opts={{}}):
            return x
    """, {"f"}, ["TRC103"]),
    "trc104_mutable_global_capture": ("""
        {mod}
        _CACHE = {{}}
        {root}
        def f(x):
            return x * _CACHE.get("scale", 1.0)
    """, {"f"}, ["TRC104"]),
    "trc104_local_shadow_clean": ("""
        {mod}
        _CACHE = {{}}
        {root}
        def f(x):
            _CACHE = {{"scale": 2.0}}
            return x * _CACHE["scale"]
    """, {"f"}, []),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_rule_matches_reference(case):
    """The reference discovers `@jax.jit`; the port is given the same
    function as a declared root (its decorator line is a comment)."""
    template, roots, want = TRACE_CASES[case]
    ref = ref_trace_pass("fixture.py", render(template, JAX))
    got = run_trace_pass("fixture.py", render(template, PORT), roots)
    assert rules(got) == want
    assert located(got) == located(ref)


def test_registered_entry_point_roots():
    """A function is checked only once it is a root, in both packages."""
    template = """
        {tns}
        def entry(x):
            return float({T}.sum(x))
    """
    for idiom, run in ((JAX, ref_trace_pass), (PORT, run_trace_pass)):
        src = render(template, idiom)
        assert run("fixture.py", src) == []
        assert rules(run("fixture.py", src, {"entry"})) == ["TRC102"]
    assert located(run_trace_pass("fixture.py", render(template, PORT),
                                  {"entry"})) == \
        located(ref_trace_pass("fixture.py", render(template, JAX),
                               {"entry"}))


# TRC103's op boundary: the reference's static_argnames case (JAX side)
# beside the port's mutates_args case on the same lines.
STATIC_ARGNAMES = """
    import functools
    import jax
    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f(x, {param}):
        return x
"""
MUTATES_ARGS = """
    import functools
    import torch
    @torch.library.custom_op("fixture::f", mutates_args=("cfg",))
    def f(x: torch.Tensor, {param}: torch.Tensor) -> None:
        return None
"""


@pytest.mark.parametrize("param,want", [("config", ["TRC103"]),
                                        ("cfg", [])],
                         ids=["bogus", "valid"])
def test_trc103_mutates_args_for_static_argnames(param, want):
    """Port-side case for the reference's static_argnames fixtures: a
    custom op whose mutates_args names no parameter is TRC103 (checked on
    every custom op of the file, as the reference checks every jit)."""
    ref = ref_trace_pass("fixture.py",
                         textwrap.dedent(STATIC_ARGNAMES).format(param=param))
    got = run_trace_pass("fixture.py",
                         textwrap.dedent(MUTATES_ARGS).format(param=param))
    assert rules(got) == want
    assert located(got) == located(ref)


PORT_TRACE_CASES = {
    # the launch counters: updated, never read for a result
    "trc104_counter_update_clean": ("""
        from typing import Dict
        LAUNCHES: Dict[str, int] = {"k": 0}
        def f(x):
            LAUNCHES["k"] += 1
            return x
    """, []),
    "trc104_counter_read": ("""
        from typing import Dict
        LAUNCHES: Dict[str, int] = {"k": 0}
        def f(x):
            LAUNCHES["k"] += 1
            return x * LAUNCHES["k"]
    """, [("TRC104", 6)]),
    "trc102_torch_syncs": ("""
        import torch
        def f(x, ev):
            a = x.cpu()
            b = x.numpy()
            c = x.tolist()
            torch.cuda.synchronize()
            ev.synchronize()
            return a, b, c, int(torch.argmax(x)), bool(x.shape[0])
    """, [("TRC102", 4), ("TRC102", 5), ("TRC102", 6), ("TRC102", 7),
          ("TRC102", 8), ("TRC102", 9)]),
    "trc101_host_values_clean": ("""
        import torch
        def f(x, y):
            if torch.is_tensor(y) and torch.cuda.is_available():
                y = y + 1
            while torch._C._len_torch_dispatch_stack() > 0:
                break
            if torch.broadcast_shapes(x.shape, y.shape) == x.shape:
                return torch.where(x > 0, x, y)
            return y
    """, []),
}


@pytest.mark.parametrize("case", sorted(PORT_TRACE_CASES))
def test_port_trace_rules(case):
    """Port-only meanings: the counter exemption of TRC104 (annotated
    globals included), the eager syncs of TRC102, TRC101's allow-list."""
    template, want = PORT_TRACE_CASES[case]
    got = run_trace_pass("fixture.py", textwrap.dedent(template), {"f"})
    assert located(got) == sorted((line, rule) for rule, line in want)


# ------------------------------------------------------ baseline semantics

class TestBaseline:
    def test_identity_is_line_free(self):
        a = Finding("KEY001", "m.py", 10, "msg")
        b = Finding("KEY001", "m.py", 99, "msg")
        new, old = split_by_baseline([b], [a])
        assert new == [] and old == [b]

    def test_roundtrip(self, tmp_path):
        f = Finding("TRC102", "m.py", 3, "sync", hint="h")
        p = tmp_path / "b.json"
        write_baseline(p, [f])
        assert load_baseline(p) == [f]

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_baseline_loads_in_the_other_package(self, tmp_path, direction):
        """Version 1 of the format, field for field: a baseline written by
        either package loads in the other with the same findings."""
        fields = [("KEY001", "src/x.py", 4, "m", "h"),
                  ("TRC104", "src/y.py", 0, "n", "")]
        p = tmp_path / "b.json"
        writer, reader, Made = (
            (ref_analysis.write_baseline, load_baseline,
             ref_analysis.Finding) if direction == "jax_to_port"
            else (write_baseline, ref_analysis.load_baseline, Finding))
        writer(p, [Made(*f) for f in fields])
        got = reader(p)
        assert [(f.rule, f.file, f.line, f.message, f.hint) for f in got] \
            == sorted(fields, key=lambda f: (f[1], f[2], f[0], f[3]))
        assert json.loads(p.read_text())["version"] == 1

    def test_clean_subtrees_enforced(self):
        for protected in ("src/repro_torch/mc/engine.py",
                          "src/repro_torch/serve/detector.py",
                          "src/repro_torch/kernels/ops.py",
                          "src/repro_torch/core/crossbar.py",
                          "src/repro_torch/device/measured.py"):
            errs = assert_clean_subtrees([Finding("KEY001", protected, 1,
                                                  "m")])
            assert len(errs) == 1
        assert assert_clean_subtrees(
            [Finding("KEY001", "src/repro_torch/launch/serve.py", 1,
                     "m")]) == []


# --------------------------------------------------------------------- CLI

BAD_FIXTURE = textwrap.dedent("""
    from repro_torch import prng
    def f(key, shape):
        a = prng.normal(key, shape)
        b = prng.normal(key, shape)
        return a + b
""")


class TestCli:
    """`python -m repro_torch.analysis` exit codes: 0 clean, 1 new
    findings, 2 baseline integrity; `--json`, `--write-baseline`."""

    def test_fail_on_new_then_baseline_then_regrow(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text(BAD_FIXTURE)
        bl = tmp_path / "baseline.json"
        base = [str(bad), "--passes", "keys", "--baseline", str(bl),
                "--device", "cpu"]

        assert cli.main(base) == 1
        assert "KEY001" in capsys.readouterr().out
        assert cli.main(base + ["--write-baseline"]) == 0
        assert json.loads(bl.read_text())["findings"][0]["rule"] == "KEY001"
        assert cli.main(base) == 0
        assert "[baselined]" in capsys.readouterr().out

        bad.write_text(BAD_FIXTURE + textwrap.dedent("""
            def g(key, shape):
                for s in shape:
                    prng.normal(key, (s,))
        """))
        assert cli.main(base) == 1
        assert cli.main(base + ["--no-fail-on-new"]) == 0

    def test_json_artifact(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text(BAD_FIXTURE)
        out = tmp_path / "findings.json"
        cli.main([str(bad), "--passes", "keys", "--baseline",
                  str(tmp_path / "b.json"), "--json", str(out),
                  "--device", "cpu"])
        doc = json.loads(out.read_text())
        assert [f["rule"] for f in doc["new"]] == ["KEY001"]
        assert "keys" in doc["timing_s"]

    def test_baselined_clean_subtree_exits_2(self, tmp_path, capsys):
        bl = tmp_path / "baseline.json"
        write_baseline(bl, [Finding("KEY001",
                                    "src/repro_torch/mc/engine.py", 1,
                                    "grandfathered-in-clean-subtree")])
        good = tmp_path / "good.py"
        good.write_text("x = 1\n")
        assert cli.main([str(good), "--passes", "keys", "--baseline",
                         str(bl), "--device", "cpu"]) == 2
        assert "bit-exactness-critical" in capsys.readouterr().err

    def test_module_entry_point_clean(self, tmp_path):
        """`python -m repro_torch.analysis` itself, the AST passes over the
        default tree: exit 0, zero findings."""
        env = dict(os.environ)
        env["PYTHONPATH"] = (str(REPO / "src") + os.pathsep
                             + env.get("PYTHONPATH", ""))
        out = tmp_path / "f.json"
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--passes",
             "keys,trace", "--device", "cpu", "--json", str(out)],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert json.loads(out.read_text())["findings"] == []


# ------------------------------------------------------------- the tree

def test_port_src_is_clean():
    """The committed baseline is EMPTY: the port's whole tree passes the
    AST passes with zero findings."""
    from repro_torch.analysis.runner import run_all
    findings, timing = run_all(passes=("keys", "trace"))
    assert findings == [], "\n".join(f.format() for f in findings)
    assert set(timing) == {"keys", "trace", "total"}


def test_committed_baseline_empty():
    bl = load_baseline(DEFAULT_BASELINE)
    assert bl == [] and assert_clean_subtrees(bl) == []


def _reference_roots():
    out = []
    for p in sorted((REPO / "src" / "repro").rglob("*.py")):
        rel = p.relative_to(REPO).as_posix()
        extra = ref_analysis.registry.JIT_ENTRY_POINTS.get(rel, set())
        out += [f"{rel}::{q}" for q in
                sorted(RefTracePass(rel, p.read_text(), extra)._roots())]
    return out


def test_every_reference_root_has_a_twin():
    """Each jit root of the JAX package is a declared root of the port (a
    function of the twin file), or a NO_TWIN entry with its reason; every
    declared root exists."""
    refs = _reference_roots()
    assert len(refs) == 26
    for ref in refs:
        twin = port_root(ref)
        if twin is None:
            assert NO_TWIN[ref].strip()
            continue
        file, qual = twin
        assert qual in HOT_PATH_ROOTS.get(file, set()), ref
    for file, roots in HOT_PATH_ROOTS.items():
        fns = TraceHygienePass(file, (REPO / file).read_text()).functions
        assert roots <= set(fns), (file, roots - set(fns))


# ------------------------------------------------------ shape contracts

@pytest.fixture(scope="module")
def contract_findings():
    """The whole contract pass on fake CPU tensors, once for the module."""
    return contracts_mod.run_contract_pass(device="cpu")


def test_repo_contracts_all_pass(contract_findings):
    assert contract_findings == [], "\n".join(f.format()
                                              for f in contract_findings)


def test_every_reference_contract_has_a_twin():
    """The reference's contract names, each a port contract of the same
    name or a NO_TWIN entry; a legacy arch's LM contract in both."""
    ref_names = [c.name for c in ref_analysis.registry.shape_contracts()]
    port = {c.name: c for c in shape_contracts()}
    assert len(ref_names) == len(port) + sum(n in NO_TWIN for n in ref_names)
    for name in ref_names:
        assert name in port or NO_TWIN[name].strip(), name
    assert {c.route for c in port.values()} == {"", "plain", "kernel"}
    assert port["detector.apply[ensemble x4,kernel]"].route == "kernel"


def test_broken_entry_point_caught(monkeypatch):
    """A transposed output -> SHP002; a raising config -> SHP001; a dtype
    drift -> SHP002."""
    def broken_transpose(inp):
        out = (inp.floats((4, 8)) @ inp.floats((8, 5))).T
        return out, _expect(out, inp, (4, 5), torch.float32, "broken_head")

    def broken_config(inp):
        from repro_torch.models.detector import DetectorConfig
        DetectorConfig(stage_channels=(60,), blocks_per_stage=(12,))
        return None, None

    def broken_dtype(inp):
        out = inp.floats((2, 3)).to(torch.bfloat16)
        return out, _expect(out, inp, (2, 3), torch.float32, "dtype_drift")

    monkeypatch.setattr(
        contracts_mod, "shape_contracts",
        lambda: [ShapeContract("broken_head", "fixture.py",
                               broken_transpose, "yolo-irc"),
                 ShapeContract("broken_cfg", "fixture.py",
                               broken_config, "yolo-irc"),
                 ShapeContract("dtype_drift", "fixture.py",
                               broken_dtype, "yolo-irc")])
    got = sorted(rules(contracts_mod.run_contract_pass(device="cpu")))
    assert got == ["SHP001", "SHP002", "SHP002"]


def test_every_arch_has_explicit_status():
    from repro_torch.configs.registry import ARCH_STATUS, list_archs
    for arch in list_archs():
        assert ARCH_STATUS.get(arch) in ("live", "legacy"), arch
    assert ARCH_STATUS["yolo-irc"] == "live"


def test_missing_status_is_flagged(monkeypatch):
    import repro_torch.configs.registry as cfg_registry
    trimmed = {k: v for k, v in cfg_registry.ARCH_STATUS.items()
               if k != "hymba-1.5b"}
    monkeypatch.setattr(cfg_registry, "ARCH_STATUS", trimmed)
    monkeypatch.setattr(contracts_mod, "shape_contracts", lambda: [])
    out = contracts_mod.run_contract_pass(device="cpu")
    assert "SHP004" in rules(out)
    assert any("hymba-1.5b" in f.message for f in out)


def test_contract_runs_real_like_fake():
    """A kernel-route contract on real seeded CPU tensors gives the fake
    run's shape, dtype and device, and finite values."""
    c = {c.name: c for c in shape_contracts()}["ensemble_apply_kernel"]
    fake, fm = c.trace("cpu")
    real, rm = c.trace("cpu", fake=False)
    assert fm is None and rm is None
    assert (fake.shape, fake.dtype, fake.device) == \
        (real.shape, real.dtype, real.device)
    assert torch.isfinite(real).all()


def test_detector_lattice_guard():
    from repro_torch.models.detector import DetectorConfig
    with pytest.raises(ValueError, match="s\\*10\\+b"):
        DetectorConfig(stage_channels=(60, 120), blocks_per_stage=(1, 10))


# ------------------------------------------------------------ fake ops

class _Passthrough(TorchDispatchMode):
    """A dispatch mode that changes nothing: its presence alone sends the
    wrappers through their custom ops."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _k1_operands(C=3, B=4, R=70, N=6, per_chip=False):
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 2, ((C, B, R) if per_chip else (B, R)),
                      generator=g).float()
    ep, en = (torch.rand(C, R, N, generator=g) for _ in range(2))
    gp, gn = ((torch.rand(R, N, generator=g) > 0.5).float()
              for _ in range(2))
    eps = torch.randn(C, B, N, generator=g)
    rnd = (torch.rand(C, B, N, generator=g) > 0.5).float()
    return x, ep, en, gp, gn, eps, rnd


def _key_calls():
    """(name, call) for each threefry wrapper and tail, on one key."""
    table = ((0.1, 0.5, 0.9), (0.6, 1.0, 1.7))
    return [
        ("fold_in int", lambda k: ops.threefry_fold_in(k, 7)),
        ("fold_in tensor", lambda k: ops.threefry_fold_in(
            k[0], torch.arange(5))),
        ("split", lambda k: ops.threefry_split(k, 3)),
        *[(f"draw {tail}", lambda k, t=tail: ops.threefry_draw(
            k, (2, 3), t, minval=-1.0, maxval=2.0, scale=0.3, p=0.25,
            table=table if t == "measured" else None))
          for tail in prng.TAILS]]


def _fake_like(t):
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


@pytest.mark.parametrize("name", [n for n, _ in _key_calls()])
def test_threefry_fake_op_matches_plain(name):
    """Each threefry op's fake output has its plain version's shape and
    dtype, and under a pass-through mode its real output is the direct
    call's, bit for bit."""
    call = dict(_key_calls())[name]
    keys = prng.fold_in(prng.PRNGKey(11, "cpu"), torch.arange(4))
    plain = call(keys)
    with FakeTensorMode():
        fake = call(_fake_like(keys))
    assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)
    with _Passthrough():
        assert torch.equal(call(keys), plain)


@pytest.mark.parametrize("per_chip", [False, True])
def test_irc_mvm_fake_ops_match_plain(per_chip):
    """K1 at every tile and K2: the fake output's shape and dtype are the
    plain version's; through the custom op (pass-through mode) the values
    are the direct call's bit for bit, word lines {0,1} or not."""
    args = _k1_operands(per_chip=per_chip)
    params = IrcEpilogueParams(sa_extra=0.25, output="binary")
    for tile in TILES:
        plain = ops.irc_mvm_chips(*args, params, tile)
        with FakeTensorMode():
            fake = ops.irc_mvm_chips(*map(_fake_like, args), params, tile)
        assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)
        with _Passthrough():
            assert torch.equal(ops.irc_mvm_chips(*args, params, tile), plain)
    if per_chip:
        return
    x, ep, en, gp, gn, eps, rnd = args
    x = x + 0.5 * (x == 0)                       # word lines not all {0,1}
    single = (x, ep[0], en[0], gp, gn, eps[0], rnd[0])
    diff = IrcEpilogueParams(output="diff", apply_ir=False)
    plain = ops.irc_mvm(*single, diff)
    with FakeTensorMode():
        fake = ops.irc_mvm(*map(_fake_like, single), diff)
    assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)
    with _Passthrough():
        assert torch.equal(ops.irc_mvm(*single, diff), plain)


def _custom_ops_entered(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()
            if e.name.startswith("repro_torch::")}


def test_custom_ops_entered_only_under_a_dispatch_mode():
    """Plain tensors with no mode active call the kernels' entry points
    directly; a dispatch mode sends every wrapper through its custom op."""
    keys = prng.fold_in(prng.PRNGKey(2, "cpu"), torch.arange(4))
    args = _k1_operands()
    params = IrcEpilogueParams()

    def run():
        for _, call in _key_calls():
            call(keys)
        ops.irc_mvm_chips(*args, params)
        x, ep, en, gp, gn, eps, rnd = args
        ops.irc_mvm(x, ep[0], en[0], gp, gn, eps[0], rnd[0], params)
        ops.xla_fma(args[1], 2.0, args[2])

    assert _custom_ops_entered(run) == set()

    def under_mode():
        with _Passthrough():
            run()
    assert _custom_ops_entered(under_mode) == {
        f"repro_torch::{n}" for n in (
            "threefry_fold_in", "threefry_split", "threefry_draw",
            "irc_mvm_chips", "irc_mvm", "xla_fma")}


def test_kernel_route_under_fake_tensors_reads_no_values():
    """The kernel route of the ensemble forward ran into K1's plain
    version's value test (`_is_bits`) under fake tensors; through the
    custom op it returns the declared shape."""
    c = {c.name: c for c in shape_contracts()}[
        "detector.apply[ensemble x4,kernel]"]
    out, mismatch = c.trace("cpu")
    assert mismatch is None and out.shape[0] == 4


def test_chip_smoke_records_and_replays_the_fake_ops():
    """Phase `analysis`'s host side on the CPU: `_recording` keeps one call
    per argument signature of each of the five wrappers on plain tensors
    (none on fake ones), restores the wrappers after, and
    `analysis_fake_ops` replays each on fake tensors against the recorded
    real output."""
    from torch_smoke_loader import chip_smoke
    smoke = chip_smoke()
    assert "analysis" in smoke.PHASES
    keys = prng.fold_in(prng.PRNGKey(2, "cpu"), torch.arange(4))
    args = _k1_operands()
    x, ep, en, gp, gn, eps, rnd = args
    params = IrcEpilogueParams()
    calls = {}
    wrappers = {n: getattr(ops, n) for n in smoke._RECORDED}
    with smoke._recording(ops, calls):
        for _ in range(2):
            for _, call in _key_calls():
                call(keys)
            ops.irc_mvm_chips(*args, params)
            ops.irc_mvm(x, ep[0], en[0], gp, gn, eps[0], rnd[0], params)
        with FakeTensorMode():
            ops.threefry_split(_fake_like(keys), 5)
    assert {n: getattr(ops, n) for n in smoke._RECORDED} == wrappers
    assert len(calls) == len(_key_calls()) + 2
    by_op = smoke.analysis_fake_ops(ops, calls)
    assert by_op == {"threefry_fold_in": 2, "threefry_split": 1,
                     "threefry_draw": len(prng.TAILS), "irc_mvm_chips": 1,
                     "irc_mvm": 1}
