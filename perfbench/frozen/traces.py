"""The paper's bursty load (Fig. 5 shape): requests a second over 1200 s.

Copied from ``src/repro_torch/data/traces.py`` ``paper_bursty_trace``
(commit 90524296), unchanged. No cell uses it yet: it is kept for the
controller's cell (``adapter-burst``, PERF.md's open questions), so that
the shape that cell replays is fixed before the program can change it.
"""
from __future__ import annotations

import numpy as np


def paper_bursty_trace(base: float = 40.0, spike: float = 95.0,
                       seconds: int = 1200, noise: float = 0.05,
                       seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float32)
    rate = np.full(seconds, base, np.float32)
    # spike 600-800
    ramp = np.clip((t - 600) / 30.0, 0, 1) * np.clip((800 - t) / 30.0, 0, 1)
    rate += (spike - base) * np.clip(ramp * 3, 0, 1) * ((t >= 600) & (t < 800))
    # gradual decrease 800-1000 back toward base*0.6
    dec = (t >= 800) & (t < 1000)
    rate[dec] = np.linspace(spike, base * 0.6, dec.sum())
    # return to initial 1000-1200
    ret = t >= 1000
    rate[ret] = np.linspace(base * 0.6, base, ret.sum())
    rate *= 1.0 + rng.normal(0, noise, seconds).astype(np.float32)
    return np.clip(rate, 0.5, None)
