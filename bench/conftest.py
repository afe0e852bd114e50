"""pytest settings of the benchmark's own tests: the `gpu` marker and the
fixture that skips a card test where there is no card (decided inside the
fixture, never at import or collection, so every xdist worker collects the
same tests), and the smoke-sized cells the CPU tests drive."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    """Register the `gpu` marker."""
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with a reason where "
                   "there is none")


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
