"""`chip_smoke.py` loaded as a module, for the port's tests of its
host-side helpers (bounds, error ratios); loading it touches no card."""
import functools
import importlib.util
from pathlib import Path


@functools.lru_cache(maxsize=1)
def chip_smoke():
    """The repository's `chip_smoke.py`, executed once per process."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke
