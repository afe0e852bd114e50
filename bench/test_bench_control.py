"""The control reads not correct: the plain reference at TF32's precision
in the program's place, at each cell's own size and limits, on the card.
Run on the card: `python -m pytest bench/test_bench_control.py` (about a
minute a cell)."""
import pytest

from benchkit import registry

SPEC = registry.load_spec()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_reads_not_correct(cuda_device, cell):
    import control
    (rec,) = control.run_control(registry.find(SPEC, cell), [(1 << 31) + 77],
                                 "tf32", cuda_device)
    assert not rec["correct"], rec["checks"]
