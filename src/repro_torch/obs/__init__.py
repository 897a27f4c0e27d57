"""Observability carried by the port so far: the metrics registry the
engine publishes into and the controller's decision audit. Tracing, rolling
windows, the SLO monitor, flight recorder and dispatch profiler are not
ported yet."""
from .audit import (DecisionAudit, DecisionRecord, attach_from_requests,  # noqa: F401
                    predict_outputs)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                       NullInstrument, NULL_REGISTRY)
