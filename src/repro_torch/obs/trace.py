"""Request lifecycle tracing and per-tick phase records.

Two record kinds, one clock domain (DESIGN.md §Observability):

* ``SpanEvent`` — a typed point on one request's timeline. Every stamp
  comes from the owning backend's single clock (``engine.clock``, the DES
  virtual clock, or a benchmark's replay clock), so events across requests
  and ticks are totally ordered in one time base. The taxonomy::

      arrival -> queued -> admitted -> prefill_chunk* -> prefill_complete
              -> decode ticks -> (preempt -> queued -> resume)* ->
              cow_bind? -> complete | drop | rejected

* ``TickRecord`` — one row per engine tick per backend: which phase the
  tick took (fused chunk vs pure decode), wall-clock cost of the
  preempt/admit/execute phases (``time.perf_counter`` — wall cost even
  when the *timeline* clock is virtual), batch geometry, queue depth, and
  paged-pool occupancy. On dispatch-profiled ticks
  (``InProcessServingEngine(profile_dispatch=N)``) the execute phase is
  further split into ``dispatch_ms`` (jit call returning — jax async
  dispatch), ``device_ms`` (``block_until_ready`` fence — device
  compute), and ``host_sync_ms`` (``np.asarray`` copy + host
  bookkeeping); NaN on unsampled ticks (see ``obs.profiler``).

``Tracer`` stores both, bounded (drops-past-cap are counted, never
silently lost — and surfaced as registry counters ``obs.spans_dropped``/
``obs.ticks_dropped`` when constructed with ``metrics=``), optionally
mirrors everything into a ``FlightRecorder`` ring (``flight=`` — the
recorder keeps the recent past even after the tracer's own caps fill),
and converts to Chrome ``trace_event`` JSON — load
``reports/TRACE_engine.json`` at https://ui.perfetto.dev. Request lanes
live under pid 1 (one thread per rid: queued/prefill/decode/preempted
slices + instants for chunks, CoW binds, preemptions); engine tick lanes
under pid 2 (one thread per backend, phase costs in ``args``).

A tracer constructed with ``enabled=False`` (or the shared
``NULL_TRACER``) keeps ``on == False`` and every hook is a one-branch
no-op — the engine's disabled-mode overhead gate in
``benchmarks/bench_engine.py`` measures exactly this path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["SpanEvent", "TickRecord", "Tracer", "NULL_TRACER",
           "EVENT_TAXONOMY", "to_chrome_trace", "validate_chrome_trace"]

# ----------------------------------------------------------------- taxonomy
ARRIVAL = "arrival"
QUEUED = "queued"
REJECTED = "rejected"
ADMITTED = "admitted"
PREFILL_CHUNK = "prefill_chunk"
PREFILL_COMPLETE = "prefill_complete"
COW_BIND = "cow_bind"
PREEMPT = "preempt"
RESUME = "resume"
COMPLETE = "complete"
DROP = "drop"
ROUTED = "routed"

EVENT_TAXONOMY = (ARRIVAL, QUEUED, REJECTED, ADMITTED, PREFILL_CHUNK,
                  PREFILL_COMPLETE, COW_BIND, PREEMPT, RESUME, COMPLETE,
                  DROP, ROUTED)

# events that end a request's timeline — nothing may be stamped after one
TERMINAL_EVENTS = frozenset({COMPLETE, DROP, REJECTED})


@dataclass(frozen=True)
class SpanEvent:
    """One typed point on a request timeline (t in clock seconds)."""
    rid: int
    name: str
    t: float
    attrs: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"rid": self.rid, "name": self.name, "t": self.t}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


@dataclass
class TickRecord:
    """Phase costs + batch geometry for one engine tick on one backend."""
    backend: str
    t: float                  # timeline clock at tick start (seconds)
    kind: str                 # "fused" | "decode" | "idle"
    preempt_ms: float = 0.0   # wall cost of the preemption phase
    admit_ms: float = 0.0     # wall cost of the admission phase
    exec_ms: float = 0.0      # wall cost of the fused-chunk / decode step
    active: int = 0           # occupied slots after admission
    prefilling: int = 0       # slots mid-prefill (chunked backends)
    queued: int = 0           # admission-queue depth after the tick
    admitted: int = 0         # requests admitted this tick
    preempted: int = 0        # requests preempted this tick
    completed: int = 0        # requests finished this tick
    pool_occupancy: float = float("nan")  # paged pool occupancy (NaN: dense)
    # dispatch-profiler split of exec_ms (NaN unless this tick was sampled
    # under profile_dispatch — fenced with block_until_ready)
    dispatch_ms: float = float("nan")   # jitted call returned (async enqueue)
    device_ms: float = float("nan")     # block_until_ready wait (device work)
    host_sync_ms: float = float("nan")  # exec remainder: D2H copy + host loop
    # async tick loop overlap fields (NaN unless engine(async_tick=True)
    # committed a previous tick's exec on this tick): with the one-tick-lag
    # commit queue, exec_ms above is the DISPATCH phase only and the
    # fields below describe the commit of tick t-1 riding this tick
    commit_ms: float = float("nan")       # commit phase wall (read + books)
    commit_gap_ms: float = float("nan")   # t-1 dispatch -> commit-read gap
    commit_wait_ms: float = float("nan")  # blocked inside the D2H read
    hidden_host_ms: float = float("nan")  # host work overlapped with t-1's
    #                                       in-flight exec (preempt + admit
    #                                       + this tick's dispatch)

    @property
    def total_ms(self) -> float:
        commit = self.commit_ms if math.isfinite(self.commit_ms) else 0.0
        return self.preempt_ms + self.admit_ms + self.exec_ms + commit

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["total_ms"] = self.total_ms
        return d


class Tracer:
    """Bounded store for span events and tick records.

    Hot-path contract: every hook first checks ``self.on`` and returns —
    a disabled tracer costs one attribute load + branch per call site.
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000,
                 max_ticks: int = 100_000, metrics=None, flight=None):
        self.on = enabled
        self.max_events = max_events
        self.max_ticks = max_ticks
        self.events: Dict[int, List[SpanEvent]] = {}
        self.ticks: List[TickRecord] = []
        self.n_events = 0
        self.dropped_events = 0
        self.dropped_ticks = 0
        # registry surfacing drops (obs.spans_dropped / obs.ticks_dropped)
        # so silent truncation shows in METRICS jsonl; None = count-only
        self.metrics = metrics
        # FlightRecorder ring: fed BEFORE the cap check — the recorder
        # keeps the recent past, the tracer keeps the bounded whole
        self.flight = flight

    # ------------------------------------------------------------ recording
    def event(self, rid: int, name: str, t: float, **attrs) -> None:
        """Stamp one lifecycle event for request ``rid`` at clock ``t``."""
        if not self.on:
            return
        span = SpanEvent(rid, name, t, attrs or None)
        if self.flight is not None:
            self.flight.push_event(span)
        if self.n_events >= self.max_events:
            self.dropped_events += 1
            if self.metrics is not None:
                self.metrics.inc("obs.spans_dropped")
            return
        lst = self.events.get(rid)
        if lst is None:
            lst = self.events[rid] = []
        lst.append(span)
        self.n_events += 1

    def request_event(self, req, name: str, t: float, **attrs) -> None:
        """Like ``event`` but also mounts the span list on ``req.spans`` so
        the Request object itself accumulates its timeline."""
        if not self.on:
            return
        self.event(req.rid, name, t, **attrs)
        req.spans = self.events.get(req.rid)

    def tick(self, record: TickRecord) -> None:
        if not self.on:
            return
        if self.flight is not None:
            self.flight.push_tick(record)
        if len(self.ticks) >= self.max_ticks:
            self.dropped_ticks += 1
            if self.metrics is not None:
                self.metrics.inc("obs.ticks_dropped")
            return
        self.ticks.append(record)

    # -------------------------------------------------------------- queries
    def events_for(self, rid: int) -> List[SpanEvent]:
        return self.events.get(rid, [])

    def summary(self) -> Dict[str, Any]:
        return {"requests": len(self.events), "events": self.n_events,
                "ticks": len(self.ticks),
                "dropped_events": self.dropped_events,
                "dropped_ticks": self.dropped_ticks}

    def to_chrome_trace(self, label: str = "repro") -> Dict[str, Any]:
        return to_chrome_trace(self, label=label)


NULL_TRACER = Tracer(enabled=False)


# ------------------------------------------------------- chrome trace_event
# phase boundaries: event name -> slice name the event OPENS on a request
# lane (None closes without opening — terminal events)
_OPENS = {QUEUED: "queued", ADMITTED: "prefill", RESUME: "prefill",
          PREFILL_COMPLETE: "decode", PREEMPT: "preempted"}
_INSTANT = {PREFILL_CHUNK, COW_BIND, ARRIVAL, ROUTED, REJECTED}

_US = 1e6  # timeline seconds -> trace_event microseconds


def _request_lane(rid: int, evs: List[SpanEvent], out: List[Dict]) -> None:
    open_name: Optional[str] = None
    open_ts = 0.0
    for ev in sorted(evs, key=lambda e: e.t):
        ts = ev.t * _US
        if ev.name in _INSTANT:
            out.append({"name": ev.name, "ph": "i", "ts": ts, "pid": 1,
                        "tid": rid, "s": "t",
                        "args": ev.attrs or {}})
            continue
        if open_name is not None:
            out.append({"name": open_name, "ph": "X", "ts": open_ts,
                        "dur": max(0.0, ts - open_ts), "pid": 1, "tid": rid,
                        "args": {}})
            open_name = None
        nxt = _OPENS.get(ev.name)
        if nxt is not None:
            open_name, open_ts = nxt, ts
        elif ev.name in (COMPLETE, DROP):
            out.append({"name": ev.name, "ph": "i", "ts": ts, "pid": 1,
                        "tid": rid, "s": "t", "args": ev.attrs or {}})
    if open_name is not None:  # request still in flight at export time
        out.append({"name": open_name + " (open)", "ph": "i", "ts": open_ts,
                    "pid": 1, "tid": rid, "s": "t", "args": {}})


def to_chrome_trace(tracer: Tracer, label: str = "repro") -> Dict[str, Any]:
    """Render a ``Tracer`` as a Chrome ``trace_event`` JSON object.

    Request lifecycles become "X" complete slices (queued/prefill/decode/
    preempted) plus "i" instants on pid 1, one tid per rid; tick records
    become "X" slices on pid 2, one tid per backend, with phase costs and
    batch geometry in ``args``. ``ts`` is the *timeline* clock in µs;
    tick ``dur`` is the measured wall cost of the tick's phases.
    """
    out: List[Dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": f"{label}: requests"}},
        {"name": "process_name", "ph": "M", "pid": 2, "tid": 0, "ts": 0,
         "args": {"name": f"{label}: engine ticks"}},
    ]
    for rid in sorted(tracer.events):
        _request_lane(rid, tracer.events[rid], out)

    backends = sorted({r.backend for r in tracer.ticks})
    tid_of = {b: i for i, b in enumerate(backends)}
    for b in backends:
        out.append({"name": "thread_name", "ph": "M", "pid": 2,
                    "tid": tid_of[b], "ts": 0, "args": {"name": b}})
    for rec in tracer.ticks:
        args = rec.to_dict()
        args.pop("backend", None)
        out.append({"name": f"tick:{rec.kind}", "ph": "X",
                    "ts": rec.t * _US,
                    "dur": max(0.0, rec.total_ms * 1e3),  # ms -> µs
                    "pid": 2, "tid": tid_of[rec.backend], "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"label": label, **tracer.summary()}}


_KNOWN_PH = {"X", "B", "E", "i", "I", "M", "C"}


def validate_chrome_trace(obj: Any) -> int:
    """Validate an object against the Chrome trace_event schema subset we
    emit. Returns the number of events; raises ``ValueError`` on the first
    malformed event (this is the CI schema gate)."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i}: missing required key {key!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"event {i}: 'name' must be a non-empty string")
        ph = ev["ph"]
        if ph not in _KNOWN_PH:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event {i}: 'ts' must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: 'X' needs numeric dur >= 0")
        if ph in ("i", "I") and ev.get("s", "t") not in ("g", "p", "t"):
            raise ValueError(f"event {i}: instant scope must be g|p|t")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: 'args' must be an object")
    return len(events)
