"""Shared cluster/serving interface — the contract between the InfAdapter
control plane and any backend that executes requests.

The paper (arXiv 2304.10892) separates the *Adapter* (forecaster + Eq. 1
solver) from the cluster it reconfigures (§4, Fig. 3). This module pins that
boundary down as two protocols so the discrete-event simulator
(`repro.sim.cluster.SimCluster`) and the real-execution engine
(`repro.serving.engine.InProcessServingEngine`) are interchangeable under the
same controller, dispatcher, and experiment harness:

  * ``ClusterAPI``  — control-plane surface: ``apply_allocation`` (the paper's
    create-then-remove reconfiguration, §5), ``loaded_variants`` (feeds the
    loading-cost LC term of Eq. 1), and ``backlog`` (queued-not-in-service
    depth, used by the beyond-paper queue-aware / reactive controller modes).
  * ``ServingAPI``  — data-plane surface on top of ``ClusterAPI``: request
    submission plus the windowed metric summary both backends report.
  * ``SchedulerAPI`` — the scheduling discipline between a backend's
    admission queue and its execution slots (admission order, chunked
    prefill, preemption); policies live in ``repro.serving.sched`` and both
    backends accept ``scheduler=`` so DES and real execution queue
    identically (INFaaS-style SLO awareness in the data plane).

Both backends also accept ``nodes=`` to mount the replica-level cluster
fabric (``repro.cluster``: placement across nodes, two-level routing via a
``RoutingAPI`` replica picker, fault injection) while staying conformant to
these same protocols — controllers never see replicas, only variants.

``summarize_requests`` is the single implementation of the paper's evaluation
metrics (SLO-violation rate, P99, average accuracy drop vs the best variant,
time-averaged cost — §6); both backends call it so the simulator and the real
engine are scored identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Dict, List, Mapping, Optional, Protocol, Sequence, Set,
                    Tuple, runtime_checkable)

import numpy as np


@dataclass
class Request:
    """One inference request travelling through a serving backend.

    ``arrival``/``completion`` are seconds on whatever clock the backend uses
    (wall clock for the real engine, simulated time for the DES) — only the
    difference is ever interpreted. ``service_start`` is stamped when the
    request leaves the admission queue and begins execution (prefill on the
    real engine, server grab in the DES), splitting end-to-end latency into
    queue wait and *processing* latency — the quantity the paper's profiler
    fits as p_m(n) (§5) and the profiling subsystem measures.

    ``slo_ms`` is the request's latency SLO; ``deadline`` (arrival + SLO) is
    what deadline-aware schedulers (``repro.serving.sched``) order and
    preempt on. ``slo_ms <= 0`` means no per-request deadline — the summary's
    global ``slo_ms`` applies. ``resume_tokens``/``preemptions``/``dropped``
    are preemption bookkeeping: a preempted request keeps the tokens it
    already generated and either re-enters the queue (requeue) or finishes
    early with ``dropped=True`` (drop).
    """
    rid: int
    tokens: np.ndarray          # prompt (prompt_len,)
    max_new: int
    arrival: float
    backend: str = ""
    service_start: float = 0.0  # 0.0 = never entered service
    completion: float = 0.0
    output: Optional[np.ndarray] = None
    accuracy: float = 0.0
    slo_ms: float = 0.0         # per-request latency SLO; <=0 = none
    priority: float = 0.0       # higher = more important (preemption tiebreak)
    preemptions: int = 0        # times this request was preempted
    resume_tokens: Optional[List[int]] = field(default=None, repr=False)
    dropped: bool = False       # preempted-and-dropped: output is partial
    # lifecycle span events (repro.obs.trace.SpanEvent), mounted by the
    # backend's tracer when tracing is on — the request accumulates its own
    # typed timeline (queued → admitted → prefill chunks → … → complete),
    # every stamp from the backend's one clock. None when tracing is off.
    spans: Optional[List] = field(default=None, repr=False, compare=False)

    @property
    def deadline(self) -> float:
        """Absolute deadline on the backend's clock (inf when no SLO)."""
        if self.slo_ms <= 0.0:
            return float("inf")
        return self.arrival + self.slo_ms / 1000.0

    @property
    def latency_ms(self) -> float:
        return (self.completion - self.arrival) * 1000.0

    @property
    def queue_wait_ms(self) -> float:
        """Admission-queue wait (arrival → service start)."""
        if self.service_start <= 0.0:
            return 0.0
        return max(self.service_start - self.arrival, 0.0) * 1000.0

    @property
    def service_ms(self) -> float:
        """Processing latency p_m(n): service start → completion, excluding
        queue wait. Falls back to end-to-end latency when the backend did
        not stamp ``service_start``."""
        if self.service_start <= 0.0:
            return self.latency_ms
        return max(self.completion - self.service_start, 0.0) * 1000.0


@runtime_checkable
class ClusterAPI(Protocol):
    """Control-plane interface the InfAdapter controller drives (paper §4)."""

    def apply_allocation(self, t: float, units: Mapping[str, int]) -> None:
        """Reconfigure backends to ``units`` (variant -> resource units).

        Semantics follow the paper's zero-downtime patch (§5): new variants
        warm up for their readiness time rt_m before taking traffic, and old
        variants retire only after the replacements are ready
        (create-then-remove)."""
        ...

    def loaded_variants(self, t: float) -> Set[str]:
        """Variants currently loaded & ready — the LC term of Eq. 1 charges
        only for variants *not* in this set."""
        ...

    def backlog(self, t: float) -> float:
        """Requests **queued but not yet in service** — admitted work still
        waiting for a server/slot; requests being processed are excluded.
        Both backends share this definition: the engine reports admission-
        queue depth (in-slot requests are in service), the simulator counts
        whole service times of per-server work beyond the request currently
        occupying each server. Feeds the queue-aware controller extension
        (λ inflated by backlog/interval to drain within one interval)."""
        ...


@runtime_checkable
class SchedulerAPI(Protocol):
    """Per-backend scheduling discipline — the layer between a backend's
    admission queue and its execution slots (implementations in
    ``repro.serving.sched``; DESIGN.md §Scheduling).

    A scheduler makes three decisions each engine tick, all pure functions of
    the visible queue/slot state (no device work):

      * **admission order** — ``order`` ranks the waiting queue; the backend
        admits the prefix that fits its free slots (FIFO = arrival order,
        EDF = earliest ``Request.deadline`` first).
      * **prefill granularity** — ``chunked`` backends split prompt prefill
        into fixed-size chunks interleaved with decode ticks, so a long
        prompt never stalls resident decode slots for a whole prefill.
      * **preemption** — ``select_victims`` names in-service requests to
        retire early (slot + pages freed, generated tokens preserved) so a
        feasible waiter can run; the engine's ``preemption=`` mode decides
        whether victims are requeued or dropped.
    """

    name: str
    chunked: bool        # engine builds the prefill-continuation machinery

    def order(self, queue: Sequence["Request"], now: float) -> List["Request"]:
        """Rank waiting requests; the backend admits a prefix of this."""
        ...

    def select_victims(self, resident: Sequence["Request"],
                       queue: Sequence["Request"], now: float,
                       free_slots: int) -> List["Request"]:
        """In-service requests to preempt this tick (may be empty)."""
        ...


@runtime_checkable
class ServingAPI(ClusterAPI, Protocol):
    """Data-plane surface: what the experiment harness needs beyond control."""

    def submit(self, req: Request, backend: Optional[str]) -> bool:
        """Enqueue a request on a backend's admission queue. Returns False if
        the queue rejected it (backpressure)."""
        ...

    def step(self, now: float) -> int:
        """Advance an asynchronous backend by one scheduling tick (admission
        + one decode chunk on the real engine). Synchronous backends (the
        discrete-event simulator serves at submit time) no-op and return 0.
        Returns the number of requests completed by this call."""
        ...

    def drain(self, now: float) -> int:
        """Serve everything still queued or in flight; no-op on synchronous
        backends. Returns the number of requests completed by this call."""
        ...

    def summarize(self, slo_ms: float, best_accuracy: float) -> Dict:
        ...


def summarize_requests(arrivals: Sequence[float], latencies_ms: Sequence[float],
                       accuracies: Sequence[float], *, slo_ms: float,
                       best_accuracy: float,
                       cost_samples: Optional[Sequence[Tuple[float, int]]] = None,
                       window_s: float = 0.0,
                       queue_ms: Optional[Sequence[float]] = None,
                       service_ms: Optional[Sequence[float]] = None,
                       slo_list_ms: Optional[Sequence[float]] = None,
                       dropped: Optional[Sequence[bool]] = None) -> Dict:
    """The paper's evaluation summary (§6), shared by sim and real engine.

    Returns violation rate / P99 / mean latency / average accuracy and the
    accuracy *loss* vs the most accurate variant; with ``cost_samples`` the
    time-averaged provisioned units (the RC term integrated over time); with
    ``window_s`` also per-window series (the paper's Fig. 5/8 time plots) and
    ``violation_seconds`` (number of wall-clock seconds containing at least
    one violation — the unit the paper reports its 65% reduction in). With
    ``queue_ms``/``service_ms`` (the queue-wait / processing-latency split of
    each request, paper §5) also mean/P99 of each component — the processing
    side is what profile fits p_m(n) are checked against.

    **Goodput** — the fraction of requests that completed in full (not
    ``dropped``) within their deadline — is reported next to P99. Each
    request's effective SLO is its own ``slo_list_ms`` entry when positive,
    else the global ``slo_ms``; without per-request SLOs and drops, goodput
    is exactly ``1 - violation_rate``. This is the paper's objective stated
    per-request (INFaaS/Loki report the same quantity as "SLO attainment").

    Latency, queue wait, and service time each report p50/p95 alongside the
    p99 the paper headlines (tail shape, not just the tail point). When
    ``slo_list_ms`` is heterogeneous — more than one distinct positive SLO —
    ``slo_classes`` breaks n/goodput/p50/p99 out per SLO class, keyed by the
    class's SLO in ms (the multi-tenant view a per-class-aware controller
    consumes).
    """
    if len(arrivals) == 0:
        return {}
    order = np.argsort(np.asarray(arrivals, float))
    arr = np.asarray(arrivals, float)[order]
    lat = np.asarray(latencies_ms, float)[order]
    acc = np.asarray(accuracies, float)[order]
    viol = lat > slo_ms
    eff_slo = np.full(len(arr), slo_ms, float)
    if slo_list_ms is not None and len(slo_list_ms):
        per = np.asarray(slo_list_ms, float)[order]
        eff_slo = np.where(per > 0, per, eff_slo)
    ok = lat <= eff_slo
    if dropped is not None and len(dropped):
        ok &= ~np.asarray(dropped, bool)[order]
    out: Dict = {
        "n_requests": int(len(arr)),
        "violation_rate": float(viol.mean()),
        "goodput": float(ok.mean()),
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_latency_ms": float(lat.mean()),
        "avg_accuracy": float(acc.mean()),
        "accuracy_loss": float(best_accuracy - acc.mean()),
    }
    if queue_ms is not None and len(queue_ms):
        q = np.asarray(queue_ms, float)
        out["mean_queue_ms"] = float(q.mean())
        out["p50_queue_ms"] = float(np.percentile(q, 50))
        out["p95_queue_ms"] = float(np.percentile(q, 95))
        out["p99_queue_ms"] = float(np.percentile(q, 99))
    if service_ms is not None and len(service_ms):
        s = np.asarray(service_ms, float)
        out["mean_service_ms"] = float(s.mean())
        out["p50_service_ms"] = float(np.percentile(s, 50))
        out["p95_service_ms"] = float(np.percentile(s, 95))
        out["p99_service_ms"] = float(np.percentile(s, 99))
    if slo_list_ms is not None and len(slo_list_ms):
        classes = sorted({float(v) for v in np.asarray(slo_list_ms, float)
                          if v > 0})
        if len(classes) > 1:        # heterogeneous SLOs: per-class breakdown
            per = np.asarray(slo_list_ms, float)[order]
            out["slo_classes"] = {}
            for c in classes:
                m = per == c
                out["slo_classes"][f"{c:g}"] = {
                    "n_requests": int(m.sum()),
                    "goodput": float(ok[m].mean()),
                    "p50_ms": float(np.percentile(lat[m], 50)),
                    "p99_ms": float(np.percentile(lat[m], 99)),
                }
    if cost_samples is not None:
        cost_t = np.array([c[0] for c in cost_samples], float)
        cost_v = np.array([c[1] for c in cost_samples], float)
        if len(cost_t) > 1:
            out["avg_cost_units"] = float(
                np.trapezoid(cost_v, cost_t) / max(cost_t[-1] - cost_t[0], 1e-9))
        else:
            out["avg_cost_units"] = float(cost_v.mean()) if len(cost_v) else 0.0
    if window_s > 0:
        out["violation_seconds"] = float(
            len({int(a) for a, v in zip(arr, viol) if v}))
        wins, p99s, accs, vrate = [], [], [], []
        # anchor windows at the first arrival's window boundary — arrivals may
        # be epoch wall-clock stamps, not trace-relative seconds
        t0 = np.floor(arr.min() / window_s) * window_s
        for w0 in np.arange(t0, arr.max(), window_s):
            m = (arr >= w0) & (arr < w0 + window_s)
            if m.sum() > 3:
                wins.append(float(w0))
                p99s.append(float(np.percentile(lat[m], 99)))
                accs.append(float(acc[m].mean()))
                vrate.append(float(viol[m].mean()))
        out["windows"] = {"t": wins, "p99_ms": p99s, "accuracy": accs,
                         "violation_rate": vrate}
    return out
