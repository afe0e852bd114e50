"""Plain references of the benchmark's configurations: plain PyTorch and
NumPy, importing nothing of the program under test (and no JAX)."""
