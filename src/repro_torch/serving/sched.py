"""Scheduling policies for the serving backends (``SchedulerAPI``): a copy
of the reference's ``repro.serving.sched`` (host code, no device work).

The paper's objective is meeting latency SLOs while maximizing
accuracy-minus-cost, but allocation alone can't fix *ordering*: a strict-FIFO
queue with monolithic prefill head-of-line-blocks short interactive requests
behind long prompts, and the controllers then over-provision against the
resulting P99. INFaaS (PAPERS.md) makes the case that SLO-aware selection
needs per-request deadlines visible in the data plane; Loki that SLOs must be
enforced at the scheduling layer. This module is that layer, shared by the
real engine and the DES:

  * ``fifo``    — arrival order, monolithic prefill, no preemption. Exactly
    the pre-scheduler behavior; the default everywhere.
  * ``edf``     — earliest-deadline-first admission (``Request.deadline =
    arrival + slo_ms``). Requests whose deadline has already passed sort
    *after* all still-feasible ones (deadline order within each class):
    serving a hopeless request before a feasible one converts one violation
    into two.
  * ``chunked`` — EDF admission (or FIFO via ``order="fifo"``) plus chunked
    prefill: the backend splits prompt prefill into fixed-size chunks
    interleaved with decode ticks, so no resident decode step ever waits
    longer than one chunk (Sarathi-style stall-free scheduling).

Preemption is orthogonal and opt-in (the engine's ``preemption=`` mode):
``select_victims`` names in-service requests whose deadline has passed while
feasible work waits and no slot is free. Victims keep their generated tokens
(``Request.resume_tokens``) and are requeued (completing later from where
they stopped) or dropped. ``Request.preemptions`` bounds how often one
request may be preempted, so a hopeless request still finishes instead of
thrashing admit/preempt forever.
"""
from __future__ import annotations

from typing import List, Sequence, Union

from repro_torch.serving.api import Request, SchedulerAPI

__all__ = ["FIFOScheduler", "EDFScheduler", "ChunkedScheduler",
           "make_scheduler", "migration_target", "MAX_PREEMPTIONS"]

# a request preempted this many times is never preempted again — bounded
# disruption, so preemption cannot livelock a request (property-tested)
MAX_PREEMPTIONS = 2


class FIFOScheduler:
    """Arrival order, monolithic prefill, no preemption — the pre-scheduler
    engine behavior, byte-for-byte."""

    name = "fifo"
    chunked = False

    def describe(self) -> dict:
        """Policy metadata for traces and audit logs ."""
        return {"policy": self.name, "chunked": self.chunked,
                "admission": getattr(self, "_order", self.name)}

    def order(self, queue: Sequence[Request], now: float) -> List[Request]:
        return list(queue)

    def select_victims(self, resident: Sequence[Request],
                       queue: Sequence[Request], now: float,
                       free_slots: int) -> List[Request]:
        return []


def _edf_key(r: Request, now: float):
    """Feasible-first EDF: requests whose deadline already passed sort after
    every still-feasible request (then by deadline, priority, arrival)."""
    return (r.deadline <= now, r.deadline, -r.priority, r.arrival)


class EDFScheduler:
    """Earliest-deadline-first admission over ``Request.deadline``.

    Preemption (only consulted when the engine enables it): while feasible
    requests wait and no slot is free, in-service requests whose deadline
    has passed are retired — latest deadline and lowest priority first —
    freeing slots/pages for work that can still meet its SLO.
    """

    name = "edf"
    chunked = False

    def describe(self) -> dict:
        """Policy metadata for traces and audit logs ."""
        return {"policy": self.name, "chunked": self.chunked,
                "admission": getattr(self, "_order", "edf"),
                "max_preemptions": MAX_PREEMPTIONS}

    def order(self, queue: Sequence[Request], now: float) -> List[Request]:
        return sorted(queue, key=lambda r: _edf_key(r, now))

    def select_victims(self, resident: Sequence[Request],
                       queue: Sequence[Request], now: float,
                       free_slots: int) -> List[Request]:
        feasible_waiting = sum(1 for r in queue if r.deadline > now)
        want = feasible_waiting - free_slots
        if want <= 0:
            return []
        hopeless = [r for r in resident
                    if r.deadline <= now and r.preemptions < MAX_PREEMPTIONS]
        hopeless.sort(key=lambda r: (-r.deadline, r.priority))  # latest first
        return hopeless[:want]


class ChunkedScheduler(EDFScheduler):
    """EDF (default) or FIFO admission + chunked prefill.

    The backend splits each prompt's prefill into ``prefill_chunk``-token
    chunks, one per engine tick, interleaved with decode chunks — bounding
    how long any resident decode slot waits on new admissions regardless of
    prompt length. Ordering and preemption are inherited from EDF unless
    constructed with ``order="fifo"``.
    """

    name = "chunked"
    chunked = True

    def __init__(self, order: str = "edf"):
        assert order in ("edf", "fifo"), order
        self._order = order
        if order != "edf":
            self.name = f"chunked-{order}"

    def order(self, queue: Sequence[Request], now: float) -> List[Request]:
        if self._order == "fifo":
            return list(queue)
        return super().order(queue, now)


def make_scheduler(spec: Union[str, SchedulerAPI]) -> SchedulerAPI:
    """Resolve ``"fifo" | "edf" | "chunked" | "chunked-fifo"`` (or pass a
    ``SchedulerAPI`` instance through) — the shared factory both backends
    call from their ``scheduler=`` parameter."""
    if not isinstance(spec, str):
        return spec
    if spec == "fifo":
        return FIFOScheduler()
    if spec == "edf":
        return EDFScheduler()
    if spec == "chunked":
        return ChunkedScheduler()
    if spec == "chunked-fifo":
        return ChunkedScheduler(order="fifo")
    raise ValueError(f"unknown scheduler {spec!r} "
                     "(expected fifo|edf|chunked|chunked-fifo)")


def migration_target(current: str, backends, queues) -> Union[str, None]:
    """Pick where a preempted request should resume under the engine's
    ``preemption="migrate"`` mode: the *cheapest* (lowest-accuracy) loaded
    backend strictly cheaper than the one it was preempted from, breaking
    ties by shortest queue — the accuracy-for-latency escape hatch of
    cross-variant migration (resume is a chunked prefill continuation, so
    any backend with the machinery can pick the request up with every
    generated token preserved). Returns None when nothing cheaper is
    loaded: the request requeues where it was, plain ``"requeue"``
    semantics."""
    cur_acc = backends[current].accuracy
    cheaper = [n for n, b in backends.items()
               if n != current and b.accuracy < cur_acc]
    if not cheaper:
        return None
    return min(cheaper, key=lambda n: (backends[n].accuracy,
                                       len(queues.get(n, ())), n))
