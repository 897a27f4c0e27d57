"""Workload forecasting: the paper's LSTM and the simpler baselines.

Paper-faithful configuration (§5 "Load forecaster"): a 25-unit LSTM layer
followed by a 1-unit dense output, trained with Adam on MSE; input is the
per-second load of the past 10 minutes (600 steps), target is the *maximum*
load of the next minute. The port of the reference's JAX LSTM
(``lstm_init``, ``lstm_apply``, ``LSTMForecaster``,
``train_lstm_forecaster``): a plain recurrence over the steps on tensors,
with the port's Adam (``repro_torch.train.optimizer``), on the card unless
the caller passes ``device="cpu"``. The batch indices are numpy's
``default_rng(seed)`` draws, as in the reference.

Copies of the reference package's host-only forecasters follow:
``MovingMaxForecaster``, ``SeasonalMaxForecaster`` (seasonal-naive max),
``EnsembleMaxForecaster`` (elementwise max of its members) and
``forecast_mae``, the evaluation the forecaster benchmark reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.optimizer import (AdamConfig, adam_init, adam_update,
                                         value_and_grad)

HISTORY = 600     # seconds of input history (10 min)
HORIZON = 60      # predict max load over the next minute


# ---------------------------------------------------------------------------
# LSTM core
# ---------------------------------------------------------------------------

def lstm_init(gen: torch.Generator, hidden: int = 25,
              input_dim: int = 1) -> Dict:
    """The reference's distributions (σ = 1/√hidden normals, zero biases),
    fp32 on ``gen.device``, drawn from ``gen``."""
    dev = gen.device
    scale = 1.0 / np.sqrt(hidden)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return {
        "wx": normal((input_dim, 4 * hidden)),
        "wh": normal((hidden, 4 * hidden)),
        "b": torch.zeros(4 * hidden, device=dev),
        "dense_w": normal((hidden, 1)),
        "dense_b": torch.zeros(1, device=dev),
    }


def lstm_apply(params: Dict, seq: torch.Tensor) -> torch.Tensor:
    """seq: (B, T, 1) normalized loads -> (B,) predicted (normalized) max.
    Gates in the order i, f, g, o; the forget gate's bias is offset by
    +1.0, as in the reference (``src/repro/core/forecaster.py:52``)."""
    B, T = seq.shape[0], seq.shape[1]
    H = params["wh"].shape[0]
    h = seq.new_zeros((B, H))
    c = seq.new_zeros((B, H))
    for t in range(T):
        z = seq[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    out = h @ params["dense_w"] + params["dense_b"]
    return out[:, 0]


def _windows(trace: np.ndarray, history: int, horizon: int, stride: int = 30
             ) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for t in range(history, len(trace) - horizon, stride):
        xs.append(trace[t - history:t])
        ys.append(trace[t:t + horizon].max())
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


@dataclass
class LSTMForecaster:
    """Paper's forecaster. Normalizes by the training trace's max; runs on
    its params' device."""
    params: Dict
    scale: float
    history: int = HISTORY
    horizon: int = HORIZON

    def predict(self, recent: np.ndarray) -> float:
        """recent: per-second loads (uses the trailing ``history`` seconds)."""
        h = np.asarray(recent, np.float32)[-self.history:]
        if len(h) < self.history:
            h = np.pad(h, (self.history - len(h), 0), mode="edge")
        x = torch.as_tensor(h / self.scale,
                            device=self.params["wh"].device)[None, :, None]
        with torch.no_grad():
            y = float(lstm_apply(self.params, x)[0]) * self.scale
        return max(y, 0.0)


def _mse(params: Dict, xb: torch.Tensor, yb: torch.Tensor):
    pred = lstm_apply(params, xb[:, :, None])
    return torch.mean(torch.square(pred - yb)), {}


def train_lstm_forecaster(trace: np.ndarray, *, hidden: int = 25,
                          steps: int = 400, batch: int = 64,
                          history: int = HISTORY, horizon: int = HORIZON,
                          lr: float = 3e-3, seed: int = 0,
                          device: Optional[Union[str, torch.device]] = None,
                          ) -> Tuple[LSTMForecaster, List[float]]:
    """Train on a per-second load trace (the paper uses 2 weeks of the
    Twitter trace; this trains on the generator's training split). The
    initial params are drawn on the CPU from ``seed`` and moved, so one
    seed starts every device from the same params; the windows live on
    ``device`` (``None``: the card) and each step gathers its batch
    there."""
    dev = resolve_device(device)
    scale = float(max(trace.max(), 1.0))
    xs, ys = _windows(trace, history, horizon)
    xs, ys = xs / scale, ys / scale
    params = {k: v.to(dev) for k, v in lstm_init(
        torch.Generator().manual_seed(seed), hidden).items()}
    opt_cfg = AdamConfig(lr=lr, warmup_steps=20, total_steps=steps,
                         schedule="cosine", grad_clip=1.0)
    opt_state = adam_init(params)
    rng = np.random.default_rng(seed)
    xs_d, ys_d = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)

    losses = []
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(xs), size=batch)).to(dev)
        (loss, _), grads = value_and_grad(_mse, params, xs_d[idx], ys_d[idx])
        params, opt_state, _ = adam_update(opt_cfg, grads, opt_state, params)
        losses.append(float(loss))
    return LSTMForecaster(params=params, scale=scale, history=history,
                          horizon=horizon), losses


# ---------------------------------------------------------------------------
# Baseline / ensemble forecasters (beyond paper)
# ---------------------------------------------------------------------------

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
