"""Synthetic data (numpy, seeded): detection images and LM token streams."""
