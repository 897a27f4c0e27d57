"""Rolling-window metric aggregation — the online tier of the registry
(DESIGN.md §Observability, "Online tier").

The cumulative instruments in ``registry.py`` answer "what happened since
the run started"; controllers reacting mid-run need "what happened in the
last N seconds". This module adds time-bucketed ring-buffer instruments:

* ``WindowedCounter``   — per-bucket increment totals; query ``total``/
  ``rate`` over any sub-window up to the ring span.
* ``WindowedHistogram`` — per-bucket count/sum plus a bounded sample list;
  query ``percentile``/``mean``/``count`` over a sub-window.
* ``MetricWindows``     — the name -> windowed-instrument map mounted on an
  ``Observability`` bundle next to the cumulative registry. Publishers feed
  BOTH surfaces under the SAME metric names (``requests.completed``,
  ``request.latency_ms``, ...), so a dashboard reading windows and a
  post-run report reading the registry never disagree on vocabulary.

Clock-domain rule (the same one span tracing obeys): every ``t`` handed to
a windowed instrument comes from the owning backend's ONE clock — the
engine's ``clock=`` callable, the DES virtual time, or a benchmark replay
clock. The ring has no clock of its own; it only quantizes the stamps it
is given into ``bucket_s``-wide buckets.

Advance is O(1) amortized: moving the newest bucket forward zeroes at most
``n_buckets`` slots regardless of how far the clock jumped (a jump past
the whole ring resets it wholesale). Stamps that arrive *behind* the
newest bucket (DES completions observed out of submit order) clamp into
the newest bucket instead of resurrecting expired ones — windows are
approximations by construction; monotone per-backend clocks make the
approximation exact.

``NULL_WINDOWS`` is the shared disabled singleton: ``on`` is False and
every hook no-ops, so an un-windowed engine pays one attribute check per
call site (covered by the bench_engine disabled-hook gate).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["WindowedCounter", "WindowedHistogram", "MetricWindows",
           "NULL_WINDOWS", "DEFAULT_WINDOW_S", "DEFAULT_BUCKETS"]

DEFAULT_WINDOW_S = 60.0   # ring span: the slowest burn-rate window fits
DEFAULT_BUCKETS = 60      # 1 s buckets — fast windows quantize to seconds
DEFAULT_BUCKET_SAMPLES = 64  # histogram samples kept per bucket


class _Ring:
    """Shared ring-index arithmetic: absolute bucket index -> slot."""

    __slots__ = ("name", "bucket_s", "n", "_cur")

    def __init__(self, name: str, window_s: float, n_buckets: int):
        assert window_s > 0 and n_buckets > 0
        self.name = name
        self.bucket_s = window_s / n_buckets
        self.n = n_buckets
        self._cur: Optional[int] = None   # absolute index of newest bucket

    @property
    def window_s(self) -> float:
        return self.bucket_s * self.n

    def _bucket(self, t: float) -> int:
        return int(t // self.bucket_s)

    def _advance(self, t: float) -> int:
        """Move the newest bucket to cover ``t``; zero the buckets stepped
        over (at most ``n`` of them — O(1) amortized). Returns the slot for
        ``t``; a stamp behind the newest bucket clamps to it."""
        b = self._bucket(t)
        cur = self._cur
        if cur is None:
            self._cur = cur = b
        elif b > cur:
            for i in range(min(b - cur, self.n)):
                self._clear((cur + 1 + i) % self.n)
            self._cur = cur = b
        return cur % self.n

    def _live_slots(self, t: float, window_s: Optional[float]) -> List[int]:
        """Slots covering the last ``window_s`` seconds ending at the newest
        bucket (after advancing to ``t``)."""
        self._advance(t)
        w = self.window_s if window_s is None else \
            min(window_s, self.window_s)
        k = max(1, min(self.n, int(np.ceil(w / self.bucket_s))))
        cur = self._cur
        return [(cur - i) % self.n for i in range(k)]

    def _clear(self, slot: int) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class WindowedCounter(_Ring):
    """Ring of per-bucket increment totals."""

    __slots__ = ("_vals",)

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 n_buckets: int = DEFAULT_BUCKETS):
        super().__init__(name, window_s, n_buckets)
        self._vals = [0.0] * n_buckets

    def _clear(self, slot: int) -> None:
        self._vals[slot] = 0.0

    def inc(self, t: float, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"window {self.name}: negative inc {amount}")
        self._vals[self._advance(t)] += amount

    def total(self, t: float, window_s: Optional[float] = None) -> float:
        """Sum over the trailing ``window_s`` (whole ring by default)."""
        return sum(self._vals[s] for s in self._live_slots(t, window_s))

    def rate(self, t: float, window_s: Optional[float] = None) -> float:
        """Events per second over the trailing window."""
        w = self.window_s if window_s is None else \
            min(window_s, self.window_s)
        return self.total(t, window_s) / max(w, 1e-12)

    def snapshot(self, t: float) -> Dict:
        return {"name": self.name, "kind": "window_counter",
                "window_s": self.window_s, "total": self.total(t),
                "rate": self.rate(t)}


class WindowedHistogram(_Ring):
    """Ring of per-bucket (count, sum, bounded samples) cells. Quantiles
    merge the live buckets' samples — estimates once a bucket overflows
    ``cap`` samples (first-``cap`` kept; count/sum stay exact)."""

    __slots__ = ("cap", "_count", "_sum", "_samples")

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 n_buckets: int = DEFAULT_BUCKETS,
                 cap: int = DEFAULT_BUCKET_SAMPLES):
        super().__init__(name, window_s, n_buckets)
        self.cap = cap
        self._count = [0] * n_buckets
        self._sum = [0.0] * n_buckets
        self._samples: List[List[float]] = [[] for _ in range(n_buckets)]

    def _clear(self, slot: int) -> None:
        self._count[slot] = 0
        self._sum[slot] = 0.0
        self._samples[slot] = []

    def observe(self, t: float, value: float) -> None:
        s = self._advance(t)
        v = float(value)
        self._count[s] += 1
        self._sum[s] += v
        if len(self._samples[s]) < self.cap:
            self._samples[s].append(v)

    def count(self, t: float, window_s: Optional[float] = None) -> int:
        return sum(self._count[s] for s in self._live_slots(t, window_s))

    def mean(self, t: float, window_s: Optional[float] = None) -> float:
        slots = self._live_slots(t, window_s)
        n = sum(self._count[s] for s in slots)
        return sum(self._sum[s] for s in slots) / n if n else float("nan")

    def percentile(self, t: float, p: float,
                   window_s: Optional[float] = None) -> float:
        vals: List[float] = []
        for s in self._live_slots(t, window_s):
            vals.extend(self._samples[s])
        if not vals:
            return float("nan")
        return float(np.percentile(np.asarray(vals), p))

    def snapshot(self, t: float) -> Dict:
        out = {"name": self.name, "kind": "window_histogram",
               "window_s": self.window_s, "count": self.count(t)}
        if out["count"]:
            out.update(mean=self.mean(t), p50=self.percentile(t, 50),
                       p99=self.percentile(t, 99))
        return out


class MetricWindows:
    """Name -> windowed instrument map, one per serving backend, mounted on
    the ``Observability`` bundle next to the cumulative registry.

    Hot-path contract mirrors the tracer's: call sites check ``self.on``
    and skip — a disabled ``MetricWindows`` (or the shared
    ``NULL_WINDOWS``) costs one attribute load + branch.
    """

    def __init__(self, enabled: bool = True,
                 window_s: float = DEFAULT_WINDOW_S,
                 n_buckets: int = DEFAULT_BUCKETS,
                 hist_cap: int = DEFAULT_BUCKET_SAMPLES):
        self.on = enabled
        self.window_s = window_s
        self.n_buckets = n_buckets
        self.hist_cap = hist_cap
        self._metrics: Dict[str, _Ring] = {}

    # ------------------------------------------------------------ factories
    def counter(self, name: str) -> WindowedCounter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = WindowedCounter(
                name, self.window_s, self.n_buckets)
        return m

    def histogram(self, name: str) -> WindowedHistogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = WindowedHistogram(
                name, self.window_s, self.n_buckets, cap=self.hist_cap)
        return m

    # ---------------------------------------------------------- convenience
    def inc(self, name: str, t: float, amount: float = 1) -> None:
        if self.on:
            self.counter(name).inc(t, amount)

    def observe(self, name: str, t: float, value: float) -> None:
        if self.on:
            self.histogram(name).observe(t, value)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def rate(self, name: str, t: float,
             window_s: Optional[float] = None) -> float:
        m = self._metrics.get(name)
        return m.rate(t, window_s) if isinstance(m, WindowedCounter) else 0.0

    # -------------------------------------------------------------- export
    def snapshot(self, t: float) -> List[Dict]:
        """One row per instrument at clock ``t`` — rows carry
        ``kind: window_counter | window_histogram`` so they can ride in the
        same METRICS jsonl dump as the cumulative registry's rows."""
        return [self._metrics[n].snapshot(t) for n in self.names()]


NULL_WINDOWS = MetricWindows(enabled=False)
