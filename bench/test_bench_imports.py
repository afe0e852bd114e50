"""What the benchmark's modules may import, by AST: nothing under bench/
imports JAX, jaxlib, ml_dtypes or the JAX package `repro` (top-level names
compared whole, so the port `repro_torch` passes); nothing under
bench/reference/ imports the port; nothing reads the JAX package's
benchmark record."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}


def _tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not FORBIDDEN.intersection(_tops(path))


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.relative_to(BENCH).parts],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_tops(path))


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.prng\nfrom repro_torch import ops\n")
    assert not FORBIDDEN.intersection(_tops(f))
    f.write_text("from repro.core import crossbar\n")
    assert FORBIDDEN.intersection(_tops(f)) == {"repro"}


def test_nothing_reads_the_jax_packages_record():
    names = ("BENCH_" + "mc.json", "benchmarks" + "/")
    for path in FILES:
        text = path.read_text()
        assert not any(n in text for n in names), path
