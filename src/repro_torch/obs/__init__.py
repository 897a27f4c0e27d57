"""Observability layer: metrics registry, request lifecycle tracing,
controller decision audit, and the online tier — rolling windows, SLO
burn-rate alerting, and the anomaly flight recorder (DESIGN.md
§Observability).

Everything funnels through one ``Observability`` bundle — a metrics
registry, a tracer, and a rolling-window map — constructed once per
serving backend (engine or SimCluster) and handed down to schedulers,
variant backends, the paged-KV pool, and routers. Metrics are on by
default (counter bumps cost what the old ad-hoc attribute counters cost);
tracing (``trace=True``) and windows (``windows=True``) are opt-in
because they allocate per-request/per-bucket state. A ``flight=``
``FlightRecorder`` mirrors spans/ticks into a bounded recent-past ring
(and implies tracing — the recorder rides the tracer's hooks).
``Observability.disabled()`` turns the whole layer into shared no-op
singletons for overhead studies.
"""
from __future__ import annotations

from typing import Optional

from .audit import (DecisionAudit, DecisionRecord, attach_from_requests,
                    predict_outputs)
from .flightrec import FlightRecorder, FlightTrigger
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       NullInstrument, NULL_REGISTRY)
from .slo import (Alert, AlertSink, BurnRateRule, CollectingSink,
                  SLOMonitor, slo_class_key)
from .profiler import dispatch_floor_summary
from .trace import (EVENT_TAXONOMY, NULL_TRACER, SpanEvent, TickRecord,
                    Tracer, to_chrome_trace, validate_chrome_trace)
from .windows import (MetricWindows, NULL_WINDOWS, WindowedCounter,
                      WindowedHistogram)

__all__ = ["Observability", "MetricsRegistry", "NULL_REGISTRY", "Counter",
           "Gauge", "Histogram", "NullInstrument", "Tracer", "NULL_TRACER",
           "SpanEvent", "TickRecord", "EVENT_TAXONOMY", "to_chrome_trace",
           "validate_chrome_trace", "DecisionAudit", "DecisionRecord",
           "predict_outputs", "attach_from_requests", "MetricWindows",
           "NULL_WINDOWS", "WindowedCounter", "WindowedHistogram", "Alert",
           "AlertSink", "BurnRateRule", "CollectingSink", "SLOMonitor",
           "slo_class_key", "FlightRecorder", "FlightTrigger",
           "dispatch_floor_summary"]


class Observability:
    """One registry + one tracer + one window map, the unit components are
    wired with.

    Hot paths should cache ``obs.metrics`` / ``obs.tracer`` /
    ``obs.windows`` locally and call the instruments directly — the bundle
    is plumbing, not a hop.
    """

    def __init__(self, trace: bool = False, metrics: bool = True,
                 max_events: int = 200_000, windows: bool = False,
                 flight: Optional[FlightRecorder] = None):
        self.metrics = MetricsRegistry() if metrics else NULL_REGISTRY
        self.flight = flight
        if flight is not None and self.metrics.enabled:
            # drop counters exist from t=0 so METRICS dumps always carry
            # them (the CI smoke asserts them zero) — same below for trace
            trace = True   # the flight ring rides the tracer's hooks
        if trace and self.metrics.enabled:
            self.metrics.counter("obs.spans_dropped")
            self.metrics.counter("obs.ticks_dropped")
        self.tracer = (Tracer(enabled=True, max_events=max_events,
                              metrics=(self.metrics if self.metrics.enabled
                                       else None), flight=flight)
                       if trace else NULL_TRACER)
        self.windows = MetricWindows() if windows else NULL_WINDOWS

    @classmethod
    def disabled(cls) -> "Observability":
        return cls(trace=False, metrics=False)

    @property
    def tracing(self) -> bool:
        return self.tracer.on

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Observability(metrics={self.metrics.enabled}, "
                f"trace={self.tracer.on}, windows={self.windows.on}, "
                f"flight={self.flight is not None})")
