"""Workload forecasting: the moving-max baseline.

A copy of the reference package's host-only ``MovingMaxForecaster``. The
paper's LSTM forecaster is trained with JAX there and has no counterpart
here yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HISTORY = 600     # seconds of input history (10 min)
HORIZON = 60      # predict max load over the next minute


@dataclass
class MovingMaxForecaster:
    """max over the recent window, with a safety headroom factor."""
    window: int = 120
    headroom: float = 1.1

    def predict(self, recent: np.ndarray) -> float:
        h = np.asarray(recent, np.float32)
        if len(h) == 0:
            return 0.0
        return float(h[-self.window:].max() * self.headroom)
