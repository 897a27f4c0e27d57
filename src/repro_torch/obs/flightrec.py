"""Anomaly flight recorder — a bounded rear-view ring that dumps on demand.

Full tracing keeps everything (bounded only by the big tracer caps); the
flight recorder keeps only the *recent past* — deques of the last
``max_spans`` span events, ``max_ticks`` tick records, and
``max_metric_snaps`` registry counter-delta snapshots — and serializes
them to a Perfetto-loadable ``FLIGHT_<reason>.json`` when something goes
wrong:

* a burn-rate alert (``FlightTrigger`` is an ``slo.AlertSink``),
* a fault event (both backends' ``inject_fault`` trigger
  ``fault_<kind>``),
* an explicit ``trigger(reason, t)`` call.

The ring is fed by the ``Tracer`` (constructed with ``flight=``): every
span/tick lands in the ring even when the tracer's own buffers are full —
the tracer drops the *newest* past its cap (post-run artifact), the
recorder evicts the *oldest* (what just happened matters). Metric deltas
come from ``snap_metrics(t, registry)``, called periodically by the
serving loop; each snapshot stores the counters that changed since the
previous one and renders as Chrome ``"C"`` counter events (pid 3), so the
dump shows request rates around the anomaly, not lifetime totals.

Dumps are rate-limited (``min_interval_s`` per reason, ``max_dumps``
total) and validated against the same trace_event schema subset the CI
gate enforces before they hit disk.
"""
from __future__ import annotations

import json
import os
import re
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .registry import MetricsRegistry
from .slo import Alert, AlertSink
from .trace import (SpanEvent, TickRecord, _request_lane,
                    validate_chrome_trace)

__all__ = ["FlightRecorder", "FlightTrigger"]

_US = 1e6


def _sanitize(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", reason).strip("_") or "anomaly"


class FlightRecorder:
    """Bounded ring of recent spans / ticks / metric deltas + the dumper."""

    def __init__(self, out_dir: str = "reports", max_spans: int = 4096,
                 max_ticks: int = 2048, max_metric_snaps: int = 256,
                 max_dumps: int = 8, min_interval_s: float = 5.0):
        self.out_dir = out_dir
        self.spans: Deque[SpanEvent] = deque(maxlen=max_spans)
        self.ticks: Deque[TickRecord] = deque(maxlen=max_ticks)
        # (t, {counter_name: delta_since_previous_snap})
        self.metric_snaps: Deque[Tuple[float, Dict[str, float]]] = \
            deque(maxlen=max_metric_snaps)
        self.max_dumps = max_dumps
        self.min_interval_s = min_interval_s
        self.dumps: List[str] = []           # paths written, in order
        self._last_dump_t: Dict[str, float] = {}   # reason -> t
        self._dump_seq: Dict[str, int] = {}
        self._last_counters: Dict[str, float] = {}

    # ------------------------------------------------------------- feeding
    def push_event(self, ev: SpanEvent) -> None:
        self.spans.append(ev)

    def push_tick(self, rec: TickRecord) -> None:
        self.ticks.append(rec)

    def snap_metrics(self, t: float, registry: MetricsRegistry) -> None:
        """Record counter movement since the previous snapshot (empty
        deltas are kept — a quiet period is signal too)."""
        deltas: Dict[str, float] = {}
        for row in registry.snapshot():
            if row.get("kind") != "counter":
                continue
            name, val = row["name"], float(row["value"])
            prev = self._last_counters.get(name, 0.0)
            if val != prev:
                deltas[name] = val - prev
            self._last_counters[name] = val
        self.metric_snaps.append((float(t), deltas))

    # ------------------------------------------------------------ dumping
    def to_chrome(self, reason: str, t: float,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Render the ring as a Chrome trace_event object: request lanes on
        pid 1 (same rendering as the full tracer), tick slices on pid 2,
        metric-delta counter tracks on pid 3."""
        out: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
             "args": {"name": "flight: requests"}},
            {"name": "process_name", "ph": "M", "pid": 2, "tid": 0, "ts": 0,
             "args": {"name": "flight: engine ticks"}},
            {"name": "process_name", "ph": "M", "pid": 3, "tid": 0, "ts": 0,
             "args": {"name": "flight: metric deltas"}},
        ]
        by_rid: Dict[int, List[SpanEvent]] = {}
        for ev in self.spans:
            by_rid.setdefault(ev.rid, []).append(ev)
        for rid in sorted(by_rid):
            _request_lane(rid, by_rid[rid], out)
        backends = sorted({r.backend for r in self.ticks})
        tid_of = {b: i for i, b in enumerate(backends)}
        for b in backends:
            out.append({"name": "thread_name", "ph": "M", "pid": 2,
                        "tid": tid_of[b], "ts": 0, "args": {"name": b}})
        for rec in self.ticks:
            args = rec.to_dict()
            args.pop("backend", None)
            out.append({"name": f"tick:{rec.kind}", "ph": "X",
                        "ts": rec.t * _US,
                        "dur": max(0.0, rec.total_ms * 1e3),
                        "pid": 2, "tid": tid_of[rec.backend], "args": args})
        for ts, deltas in self.metric_snaps:
            for name, d in deltas.items():
                out.append({"name": name, "ph": "C", "ts": ts * _US,
                            "pid": 3, "tid": 0, "args": {"delta": d}})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"flight_reason": reason, "t": t,
                              "spans": len(self.spans),
                              "ticks": len(self.ticks),
                              "metric_snaps": len(self.metric_snaps),
                              **(extra or {})}}

    def trigger(self, reason: str, t: float,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Dump ``FLIGHT_<reason>.json`` (suffixed ``_2``, ``_3``, ... on
        repeats) unless rate-limited. Returns the path, or None when the
        dump was suppressed. The object is schema-validated before writing
        — a flight dump that Perfetto can't load is worse than none."""
        reason = _sanitize(reason)
        if len(self.dumps) >= self.max_dumps:
            return None
        last = self._last_dump_t.get(reason)
        if last is not None and t - last < self.min_interval_s:
            return None
        self._last_dump_t[reason] = t
        seq = self._dump_seq.get(reason, 0) + 1
        self._dump_seq[reason] = seq
        fname = (f"FLIGHT_{reason}.json" if seq == 1
                 else f"FLIGHT_{reason}_{seq}.json")
        obj = self.to_chrome(reason, t, extra=extra)
        validate_chrome_trace(obj)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, fname)
        with open(path, "w") as f:
            json.dump(obj, f)
        self.dumps.append(path)
        return path


class FlightTrigger(AlertSink):
    """AlertSink that turns a burn-rate alert into a flight dump."""

    def __init__(self, recorder: FlightRecorder):
        self.recorder = recorder

    def emit(self, alert: Alert) -> None:
        self.recorder.trigger(f"burn_rate_{alert.slo_class}", alert.t,
                              extra=alert.to_dict())
