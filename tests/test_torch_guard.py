"""The port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports JAX, the JAX package `repro` or `ml_dtypes` (only
the tests import them)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_port():
    names = {p.name for p in _port_files()}
    assert {"prng.py", "irc_mvm.py", "detector_mc.py", "ternary_matmul.py",
            "build.py", "calibration.py", "runlog.py", "convergence.py",
            "chip_smoke.py"} <= names
    rel = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
           for p in _port_files()[:-1]}
    assert {"serve/detector.py", "serve/__init__.py",
            "launch/serve.py"} <= rel
    assert {"examples/__init__.py", "examples/train_detector.py",
            "examples/quickstart.py", "examples/paper_tables.py"} <= rel
    assert {"train_detector.py", "quickstart.py", "paper_tables.py"} <= names
    assert {"ckpt/checkpoint.py", "models/transformer.py", "serve/engine.py",
            "configs/registry.py"} <= rel
    assert {"train/steps.py", "train/trainer.py", "launch/train.py",
            "examples/train_lm.py", "examples/serve_lm.py"} <= rel
    assert {"sharding/__init__.py", "sharding/rules.py",
            "sharding/dtensor.py", "sharding/parallel.py", "launch/mesh.py",
            "launch/specs.py", "launch/dryrun.py", "launch/roofline.py",
            "launch/perf.py", "launch/summarize.py", "launch/meshcheck.py"
            } <= rel


def test_serve_cli_takes_network_lm(capsys):
    """`--network lm`, the JAX CLI's default, serves (it once exited)."""
    from repro_torch.launch import serve
    serve.main(["--network", "lm", "--device", "cpu", "--requests", "2",
                "--slots", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "req 0: 2 prompt toks" in out and "2 requests, 4 new tokens" in out
