"""In-process metrics registry — the one surface every serving component
publishes into (DESIGN.md §Observability).

InfAdapter's premise is a control loop driven by *measured* signals; before
this module those signals lived in ad-hoc summary dicts computed after the
fact (``summarize``, ``kv_pool_stats``, per-backend attribute counters).
The registry replaces them with three instrument kinds, named with the
Prometheus-style ``component.metric`` convention so the engine and the
discrete-event simulator emit the SAME metric names:

  * ``Counter``   — monotone totals (``requests.completed``,
    ``engine.prefill_tokens_total``). ``inc`` only.
  * ``Gauge``     — last-write-wins levels (``kv.occupancy``).
  * ``Histogram`` — bounded-reservoir distributions
    (``request.latency_ms``): the first ``cap`` observations are kept
    verbatim, later ones reservoir-sample (Vitter's algorithm R with a
    deterministic per-instrument RNG, so snapshots are reproducible at a
    fixed workload); ``count``/``sum`` stay exact, quantiles are estimates
    over the reservoir. p50/p95/p99 come from ``percentile``.

Zero dependencies, near-zero overhead: instruments are plain attribute
arithmetic, and a registry constructed with ``enabled=False`` hands out a
shared ``NullInstrument`` whose methods are no-ops — the disabled-mode cost
of an instrumented call site is one method call (benchmarked by the
``observability`` study in ``benchmarks/bench_engine.py``, gated ≤2% of a
tick). ``NULL_REGISTRY`` is the module-wide disabled singleton components
default to when no registry is mounted.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "NullInstrument",
           "MetricsRegistry", "NULL_REGISTRY"]

# reservoir size per histogram: large enough that p99 over a smoke run is
# exact (runs complete < cap requests), small enough to bound memory
DEFAULT_RESERVOIR = 4096


class Counter:
    """Monotone total. ``inc`` with a negative amount is a bug (raises)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: Union[int, float] = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def snapshot(self) -> Dict:
        return {"name": self.name, "kind": "counter", "value": self.value}


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: Union[int, float]) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict:
        return {"name": self.name, "kind": "gauge", "value": self.value}


class Histogram:
    """Bounded-reservoir distribution with exact count/sum.

    The reservoir keeps the first ``cap`` observations, then replaces
    uniformly at random (algorithm R) so quantiles remain an unbiased
    estimate of the full stream. The RNG is seeded from the metric name —
    identical workloads snapshot identically.
    """

    __slots__ = ("name", "cap", "count", "sum", "min", "max", "_res", "_rng")

    def __init__(self, name: str, cap: int = DEFAULT_RESERVOIR):
        self.name = name
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._res: List[float] = []
        self._rng = np.random.default_rng(abs(hash(name)) % (2 ** 32))

    def observe(self, value: Union[int, float]) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        if len(self._res) < self.cap:
            self._res.append(v)
        else:                          # algorithm R: keep with prob cap/count
            j = int(self._rng.integers(self.count))
            if j < self.cap:
                self._res[j] = v

    def percentile(self, p: float) -> float:
        """Quantile estimate over the reservoir (NaN when empty)."""
        if not self._res:
            return float("nan")
        return float(np.percentile(np.asarray(self._res), p))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> Dict:
        out = {"name": self.name, "kind": "histogram", "count": self.count,
               "sum": self.sum}
        if self.count:
            out.update(mean=self.mean, min=self.min, max=self.max,
                       p50=self.percentile(50), p95=self.percentile(95),
                       p99=self.percentile(99))
        return out


class NullInstrument:
    """Shared no-op standing in for every instrument kind when the registry
    is disabled — call sites never branch, they just pay one no-op call."""

    __slots__ = ()
    name = "null"
    value = 0.0
    count = 0
    sum = 0.0
    mean = float("nan")

    def inc(self, amount: Union[int, float] = 1) -> None:
        pass

    def set(self, value: Union[int, float]) -> None:
        pass

    def observe(self, value: Union[int, float]) -> None:
        pass

    def percentile(self, p: float) -> float:
        return float("nan")

    def snapshot(self) -> Dict:
        return {}


_NULL_INSTRUMENT = NullInstrument()


class MetricsRegistry:
    """Name -> instrument map. One per serving backend (engine or sim);
    components receive it at construction and publish through it.

    ``enabled=False`` makes every factory return the shared
    ``NullInstrument`` and every convenience helper a cheap early-return —
    the whole instrumentation layer reduces to no-op calls.
    """

    def __init__(self, enabled: bool = True,
                 reservoir: int = DEFAULT_RESERVOIR):
        self.enabled = enabled
        self.reservoir = reservoir
        self._metrics: Dict[str, object] = {}

    # ------------------------------------------------------------ factories
    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_INSTRUMENT
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_INSTRUMENT
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: Optional[int] = None) -> Histogram:
        if not self.enabled:
            return _NULL_INSTRUMENT
        return self._get(name, Histogram, cap=cap or self.reservoir)

    # ---------------------------------------------------------- convenience
    def inc(self, name: str, amount: Union[int, float] = 1) -> None:
        if self.enabled:
            self.counter(name).inc(amount)

    def set(self, name: str, value: Union[int, float]) -> None:
        if self.enabled:
            self.gauge(name).set(value)

    def observe(self, name: str, value: Union[int, float]) -> None:
        if self.enabled:
            self.histogram(name).observe(value)

    def value(self, name: str, default: float = 0.0) -> float:
        """Current value of a counter/gauge (``default`` when absent)."""
        m = self._metrics.get(name)
        return m.value if m is not None and hasattr(m, "value") else default

    def get(self, name: str):
        """The instrument itself, or None — for histogram percentiles."""
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every instrument. Publishers address instruments by name
        through the registry (never by cached object), so benchmarks that
        reuse one engine across warm-up and measured phases can zero the
        slate between them."""
        self._metrics.clear()

    # -------------------------------------------------------------- export
    def snapshot(self) -> List[Dict]:
        """One dict per instrument, name-sorted (the JSONL dump rows)."""
        return [self._metrics[n].snapshot() for n in self.names()]

    def dump_jsonl(self, path: str,
                   extra: Optional[Iterable[Dict]] = None) -> int:
        """Write ``snapshot()`` (+ optional extra rows) one JSON object per
        line — the METRICS_engine.jsonl exporter format. Returns #rows."""
        rows = list(extra or []) + self.snapshot()
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row, sort_keys=True) + "\n")
        return len(rows)


NULL_REGISTRY = MetricsRegistry(enabled=False)
