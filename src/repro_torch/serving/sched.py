"""Scheduling policies for the serving backends (``SchedulerAPI``).

A copy of the FIFO part of the reference's ``repro.serving.sched``: arrival
order, monolithic prefill, no preemption — the engine's default. The
deadline-aware ``edf`` and ``chunked`` policies, preemption and cross-variant
migration come with chunked prefill (ROADMAP A5); asking for them raises.
"""
from __future__ import annotations

from typing import List, Sequence, Union

from repro_torch.serving.api import Request, SchedulerAPI

__all__ = ["FIFOScheduler", "make_scheduler"]


class FIFOScheduler:
    """Arrival order, monolithic prefill, no preemption — the pre-scheduler
    engine behavior, byte-for-byte."""

    name = "fifo"
    chunked = False

    def describe(self) -> dict:
        """Policy metadata for traces and audit logs."""
        return {"policy": self.name, "chunked": self.chunked,
                "admission": getattr(self, "_order", self.name)}

    def order(self, queue: Sequence[Request], now: float) -> List[Request]:
        return list(queue)

    def select_victims(self, resident: Sequence[Request],
                       queue: Sequence[Request], now: float,
                       free_slots: int) -> List[Request]:
        return []


def make_scheduler(spec: Union[str, SchedulerAPI]) -> SchedulerAPI:
    """Resolve ``"fifo"`` (or pass a ``SchedulerAPI`` instance through);
    the reference's ``edf``/``chunked``/``chunked-fifo`` are not ported."""
    if not isinstance(spec, str):
        return spec
    if spec == "fifo":
        return FIFOScheduler()
    if spec in ("edf", "chunked", "chunked-fifo"):
        raise NotImplementedError(f"scheduler {spec!r} is not ported to "
                                  "repro_torch yet (ROADMAP A5)")
    raise ValueError(f"unknown scheduler {spec!r} (expected fifo)")
