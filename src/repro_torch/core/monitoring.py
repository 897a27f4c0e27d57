"""Monitoring daemon: per-second arrival-rate history from the dispatcher."""
from __future__ import annotations

from collections import deque
from typing import Deque, List

import numpy as np


class RateMonitor:
    """Counts request arrivals into 1-second buckets (paper's monitoring
    component fetches exactly this from the dispatcher)."""

    def __init__(self, horizon_s: int = 3600 * 4):
        self.horizon_s = horizon_s
        self._counts: Deque[int] = deque(maxlen=horizon_s)
        self._bucket_t: int = 0
        self._current: int = 0
        self._started = False

    def record(self, t: float, n: int = 1) -> None:
        """Record n arrivals at time t (seconds, monotone nondecreasing)."""
        sec = int(t)
        if not self._started:
            self._bucket_t, self._started = sec, True
        while sec > self._bucket_t:
            self._counts.append(self._current)
            self._current = 0
            self._bucket_t += 1
        self._current += n

    def advance_to(self, t: float) -> None:
        """Flush empty seconds up to time t."""
        self.record(t, 0)

    def history(self, seconds: int = 600) -> np.ndarray:
        """Per-second rates for the trailing window (excludes current bucket)."""
        h = np.asarray(self._counts, np.float32)
        return h[-seconds:] if len(h) else np.zeros((0,), np.float32)

    def current_rate(self, window: int = 10) -> float:
        h = self.history(window)
        return float(h.mean()) if len(h) else 0.0
