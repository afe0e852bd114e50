"""Synthetic detection data (numpy, seeded)."""
