"""Shared pytest settings: the marker of tests that need a CUDA device.

Such tests decide inside a fixture whether a card is present and skip with
a reason where there is none (never at import or collection time, so every
xdist worker collects the same tests)."""


def pytest_configure(config):
    """Register the `gpu` marker."""
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's CUDA kernels); "
                   "skips with a reason where there is none")
