"""Chip-population Monte Carlo: ensembles, the kernel-routed engine and the
whole-detector Table II sweep."""
