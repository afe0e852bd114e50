"""The numbers that decide `correct`: how far the program's outputs lie
from the plain reference's on the same inputs."""
from __future__ import annotations

import numpy as np


def mismatch_share(prog: np.ndarray, ref: np.ndarray, tol: float) -> float:
    """Share of elements where |prog - ref| > tol; 1.0 where the shapes
    differ or the program's outputs are not finite."""
    prog, ref = np.asarray(prog), np.asarray(ref)
    if prog.shape != ref.shape:
        return 1.0
    bad = ~np.isfinite(prog) | (np.abs(prog.astype(np.float64)
                                       - ref.astype(np.float64)) > tol)
    return float(bad.mean())

