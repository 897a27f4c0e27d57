"""Workload forecasting: the moving-max, seasonal and ensemble baselines.

Copies of the reference package's host-only forecasters:
``MovingMaxForecaster``, ``SeasonalMaxForecaster`` (seasonal-naive max),
``EnsembleMaxForecaster`` (elementwise max of its members) and
``forecast_mae``, the evaluation the forecaster benchmark reads. The
paper's LSTM forecaster is trained with JAX there and has no counterpart
here yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

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


@dataclass
class SeasonalMaxForecaster:
    """Seasonal-naive: max of the same minute one period ago and the recent
    minute (captures diurnal repeats in the Twitter-like trace)."""
    period: int = 3600
    fallback: MovingMaxForecaster = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.fallback is None:
            self.fallback = MovingMaxForecaster()
        self._buffer: List[float] = []

    def observe(self, value: float):
        self._buffer.append(value)

    def predict(self, recent: np.ndarray) -> float:
        base = self.fallback.predict(recent)
        buf = self._buffer
        if len(buf) >= self.period:
            seasonal = max(buf[-self.period:-self.period + HORIZON] or [0.0])
            return max(base, seasonal)
        return base


@dataclass
class EnsembleMaxForecaster:
    """Elementwise max of member forecasts: conservative (SLO-protective)."""
    members: Tuple = ()

    def predict(self, recent: np.ndarray) -> float:
        return max(m.predict(recent) for m in self.members)


def forecast_mae(forecaster, trace: np.ndarray, history: int = HISTORY,
                 horizon: int = HORIZON, stride: int = 60) -> Dict[str, float]:
    """Evaluation used by the forecaster benchmark: MAE + under-prediction
    rate (under-predictions are what cause SLO violations)."""
    errs, unders = [], []
    for t in range(history, len(trace) - horizon, stride):
        pred = forecaster.predict(trace[:t])
        true = trace[t:t + horizon].max()
        errs.append(abs(pred - true))
        unders.append(1.0 if pred < true else 0.0)
    return {"mae": float(np.mean(errs)),
            "under_rate": float(np.mean(unders))}
