"""Detector QAT (loss, step, short training loop) and host-side
detection scoring."""
