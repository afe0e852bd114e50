"""Driver of the detector service under on/off arrivals: everything as
`serve_committee.py` (set-up, window, check and control, from its own copy
of that module), except the schedule.  Arrivals are Poisson at `rate` x
(`on_s` + `off_s`) / `on_s` during the first `on_s` seconds of every
period of `on_s` + `off_s`, none in the rest, so the mean is the mix's
`rate`; one schedule for every seed (the mix's `schedule_seed`), scenes
from the seed as the steady driver draws them.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "bench_driver_serve_onoff_steady",
    Path(__file__).with_name("serve_committee.py"))
_steady = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_steady)


def _arrivals(tr: Dict[str, Any], seed: int, rate: float, seconds: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Due offsets (s from the window's start) below `seconds`, on/off,
    the same for every seed, and the scene of each request, drawn from
    the seed."""
    on, period = tr["on_s"], tr["on_s"] + tr["off_s"]
    burst = rate * period / on
    rng = np.random.default_rng((tr["schedule_seed"], 4))
    t = []
    for start in np.arange(0.0, seconds, period):
        at = start + np.cumsum(rng.exponential(1.0 / burst,
                                               size=int(burst * on * 2 + 16)))
        t.extend(at[at < min(start + on, seconds)])
    t = np.asarray(t)
    scenes = np.random.default_rng((seed, 3)).integers(tr["pool"],
                                                       size=t.size)
    return t, scenes


_steady._arrivals = _arrivals
make_inputs = _steady.make_inputs
setup = _steady.setup
window = _steady.window
check = _steady.check
control = _steady.control
