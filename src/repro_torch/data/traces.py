"""Workload traces.

The paper evaluates on a 20-minute sample of the Twitter-trace (2021-08) plus
two weeks of it for LSTM training. The dataset isn't redistributable/offline,
so we provide:

  * ``paper_bursty_trace``   — the paper's Fig. 5 shape: steady (0-600 s),
    spike (600-800 s), gradual decrease (800-1000 s), return (1000-1200 s).
  * ``paper_nonbursty_trace`` — the Fig. 8 gentle-variation counterpart.
  * ``synthetic_twitter_trace`` — long diurnal + AR(1) noise + random bursts,
    statistically matched to published Twitter-trace characteristics
    (CoV ~0.1-0.3 within hours, diurnal swing ~2x, burst factor 1.5-2.5x);
    used to train the LSTM forecaster.

All traces are per-second request rates (np.ndarray, RPS).
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


def paper_nonbursty_trace(base: float = 45.0, seconds: int = 1200,
                          swing: float = 0.35, noise: float = 0.05,
                          seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float32)
    rate = base * (1.0 + swing * np.sin(2 * np.pi * t / 900.0))
    rate *= 1.0 + rng.normal(0, noise, seconds).astype(np.float32)
    return np.clip(rate, 0.5, None)


def synthetic_twitter_trace(seconds: int = 6 * 3600, base: float = 45.0,
                            seed: int = 2) -> np.ndarray:
    """Diurnal + AR(1) + bursts; for forecaster training/eval."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float32)
    diurnal = 1.0 + 0.5 * np.sin(2 * np.pi * t / 86_400.0 - 0.8)
    hourly = 1.0 + 0.15 * np.sin(2 * np.pi * t / 3600.0)
    # AR(1) noise
    ar = np.empty(seconds, np.float32)
    ar[0] = 0.0
    phi, sig = 0.995, 0.02
    eps = rng.normal(0, sig, seconds).astype(np.float32)
    for i in range(1, seconds):
        ar[i] = phi * ar[i - 1] + eps[i]
    # random bursts (Poisson arrivals, exponential decay)
    burst = np.zeros(seconds, np.float32)
    n_bursts = max(1, seconds // 1800)
    starts = rng.integers(0, seconds, n_bursts)
    for s in starts:
        amp = rng.uniform(0.5, 1.5)
        dur = rng.integers(60, 240)
        end = min(s + dur, seconds)
        burst[s:end] += amp * np.exp(-np.arange(end - s) / (dur / 3.0))
    rate = base * diurnal * hourly * (1.0 + ar) * (1.0 + burst)
    return np.clip(rate, 0.5, None).astype(np.float32)


def arrivals_from_rate(rate: np.ndarray, seed: int = 0) -> np.ndarray:
    """Poisson arrival timestamps (seconds) for a per-second rate trace."""
    rng = np.random.default_rng(seed)
    times = []
    for sec, lam in enumerate(rate):
        n = rng.poisson(lam)
        if n:
            times.append(sec + np.sort(rng.random(n)))
    return (np.concatenate(times) if times else np.zeros((0,))).astype(np.float64)
