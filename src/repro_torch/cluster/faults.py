"""Failure scenarios: a time-ordered schedule of fault events injected into
a fabric-backed cluster, so the SLO impact of failures is measurable
end-to-end (controller re-placement included).

Event kinds (targets name fabric objects):
  * ``node_crash``       — node dies; its replicas are killed immediately
                           (the engine re-submits their in-flight and queued
                           requests to survivors; the DES loses capacity
                           from the crash instant forward);
  * ``node_recover``     — node capacity returns (replicas come back only
                           via the next controller placement);
  * ``replica_slowdown`` — one replica serves ``factor``× slower (straggler
                           / noisy neighbour);
  * ``replica_restore``  — the straggler recovers.

Clusters expose ``inject_fault(t, event)`` (see ``SimCluster`` and
``InProcessServingEngine``); ``FaultSchedule`` feeds due events to it as
time advances — ``repro.sim.runner.run_experiment`` does this automatically
when given ``faults=``, interleaved in time order with controller steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

__all__ = ["FaultEvent", "FaultSchedule", "node_crash", "node_recover",
           "replica_slowdown", "replica_restore", "FAULT_KINDS"]

FAULT_KINDS = ("node_crash", "node_recover", "replica_slowdown",
               "replica_restore")


@dataclass(frozen=True, order=True)
class FaultEvent:
    t: float
    kind: str
    target: str                  # node_id or replica rid
    factor: float = 1.0          # slowdown multiplier (replica_slowdown)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(available: {FAULT_KINDS})")


def node_crash(t: float, node_id: str) -> FaultEvent:
    return FaultEvent(t, "node_crash", node_id)


def node_recover(t: float, node_id: str) -> FaultEvent:
    return FaultEvent(t, "node_recover", node_id)


def replica_slowdown(t: float, rid: str, factor: float) -> FaultEvent:
    return FaultEvent(t, "replica_slowdown", rid, factor)


def replica_restore(t: float, rid: str) -> FaultEvent:
    return FaultEvent(t, "replica_restore", rid)


class FaultSchedule:
    """Time-ordered fault events with pop-due semantics."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._events: List[FaultEvent] = sorted(events)
        self.injected: List[FaultEvent] = []

    def add(self, event: FaultEvent) -> "FaultSchedule":
        self._events.append(event)
        self._events.sort()
        return self

    def next_t(self) -> float:
        """Time of the next pending event (inf when exhausted)."""
        return self._events[0].t if self._events else float("inf")

    def pop_due(self, t: float) -> List[FaultEvent]:
        due = [e for e in self._events if e.t <= t]
        self._events = self._events[len(due):]
        self.injected.extend(due)
        return due

    def apply_due(self, t: float, cluster) -> List[FaultEvent]:
        """Inject every event due by ``t`` into ``cluster`` (which must
        expose ``inject_fault``); returns the injected events."""
        due = self.pop_due(t)
        for e in due:
            cluster.inject_fault(e.t, e)
        return due

    def __len__(self) -> int:
        return len(self._events)
