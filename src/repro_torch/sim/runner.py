"""Experiment runner: replay a workload trace against a controller + cluster.

Reproduces the paper's evaluation harness (§6): Poisson arrivals from a
per-second rate trace (the Twitter-trace methodology of Fig. 5/8), the
controller stepping every 30 s, the dispatcher load-balancing by the solver's
quotas λ_m, and the cluster measuring windowed P99 / accuracy / cost.

The cluster is any ``ServingAPI`` implementation (``repro_torch.serving.api``) —
pass ``cluster=`` to replay against something other than a fresh
``SimCluster``. Asynchronous backends (the real engine) are ticked after
each submission and drained at the end; note their latencies are wall-clock
while arrival stamps are simulated, so absolute latency numbers are only
meaningful on the simulator — the real engine is normally driven in
wall-clock time by ``examples/serve_autoscale.py`` instead. Ensemble
(fanout) controllers additionally need the DES's ``dispatch_fanout`` and
are rejected with a clear error on other backends.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core.profiles import VariantProfile
from repro_torch.data.traces import arrivals_from_rate
from repro_torch.obs.audit import attach_from_requests
from repro_torch.serving.api import Request
from repro_torch.sim.cluster import SimCluster

_NO_TOKENS = np.zeros((0,), np.int64)   # sim requests carry no prompt


@dataclass
class ExperimentResult:
    name: str
    summary: Dict
    decisions: list

    def __repr__(self):
        s = self.summary
        return (f"<{self.name}: viol={s['violation_rate']:.3%} "
                f"p99={s['p99_ms']:.0f}ms acc_loss={s['accuracy_loss']:.2f}% "
                f"cost={s['avg_cost_units']:.1f}>")


def run_experiment(name: str, controller, profiles: Mapping[str, VariantProfile],
                   rate_trace: np.ndarray, *, slo_ms: float = 750.0,
                   interval_s: float = 30.0, seed: int = 0,
                   warm_start: Optional[Mapping[str, int]] = None,
                   reference_accuracy: Optional[float] = None,
                   cluster=None, faults=None, slo_monitor=None,
                   ) -> ExperimentResult:
    """Replay ``rate_trace`` (requests/s per second) and score the controller.

    Faithful to the paper's setup: ``interval_s=30`` s control period,
    ``slo_ms=750`` ms latency SLO, accuracy loss reported against the most
    accurate variant (Table 1). ``warm_start`` pre-loads variants as the
    paper's experiments do so t=0 isn't an artificial cold start.

    ``faults`` (a ``repro_torch.cluster.faults.FaultSchedule``) injects failure
    events into fabric-backed clusters as simulated time passes, interleaved
    in time order with controller steps — the end-to-end failure-scenario
    harness.

    ``slo_monitor`` (an ``repro_torch.obs.slo.SLOMonitor`` over the cluster's
    windowed metrics) is checked at every reactive checkpoint, in virtual
    time, before ``maybe_react`` — a controller wired with ``burn_alerts=``
    re-solves on burn-rate breach with the same semantics as the wall-clock
    driver (parity-tested).
    """
    cluster = cluster if cluster is not None else SimCluster(profiles)
    best_acc = reference_accuracy if reference_accuracy is not None \
        else max(p.accuracy for p in profiles.values())
    arrivals = arrivals_from_rate(rate_trace, seed=seed)

    # realized_shares must reflect THIS replay only — a reused controller's
    # dispatcher carries counts (and WRR phase) from previous runs
    dispatcher = getattr(controller, "dispatcher", None)
    if dispatcher is not None:
        dispatcher.reset()

    # Seed the monitor with one flushed pre-trace second of the initial rate so
    # the first decision sees a real load estimate (not the min-load floor).
    controller.monitor.record(-1.0, max(int(rate_trace[0]), 1))
    controller.monitor.advance_to(0.0)
    if warm_start:
        cluster.apply_allocation(-max(profiles[m].rt for m in warm_start),
                                 warm_start)
        # mark as instantly ready (replica-fabric clusters expose mark_warm;
        # plain backends keep the legacy direct poke)
        if hasattr(cluster, "mark_warm"):
            cluster.mark_warm(list(warm_start))
        else:
            for m in warm_start:
                cluster.backends[m].ready_at = 0.0
    controller.step(0.0, cluster)

    react_s = getattr(getattr(controller, "cfg", None), "reactive_check_s", 5.0)
    next_ctrl = interval_s
    next_react = react_s
    for rid, a in enumerate(arrivals):
        while faults is not None and faults.next_t() <= min(a, next_ctrl):
            faults.apply_due(faults.next_t(), cluster)
        while a >= next_ctrl:
            controller.monitor.advance_to(next_ctrl)
            controller.step(next_ctrl, cluster)
            next_ctrl += interval_s
            next_react = next_ctrl - interval_s + react_s
            if faults is not None and faults.next_t() <= min(a, next_ctrl):
                faults.apply_due(faults.next_t(), cluster)
        if a >= next_react and hasattr(controller, "maybe_react"):
            controller.monitor.advance_to(next_react)
            if slo_monitor is not None:
                slo_monitor.check(next_react)
            controller.maybe_react(next_react, cluster)
            next_react += react_s
        controller.monitor.record(a, 1)
        if hasattr(controller, "fanout_backends"):
            # Cocktail-style ensembling: every member serves every request.
            # Fanout needs the DES's dispatch_fanout (latency = slowest
            # member) — not part of the ServingAPI protocol, so fail clearly
            # rather than mid-replay on an arbitrary AttributeError.
            if not hasattr(cluster, "dispatch_fanout"):
                raise TypeError(
                    f"controller {type(controller).__name__} requires fanout "
                    f"dispatch, which {type(cluster).__name__} does not "
                    "support; use SimCluster for ensemble controllers")
            members = controller.fanout_backends()
            acc = controller.decisions[-1].allocation.aa \
                if controller.decisions else 0.0
            cluster.dispatch_fanout(a, members, acc)
        else:
            backend = controller.dispatcher.next_backend()
            # Rejected submissions (backpressure on the real engine) are
            # counted by that backend's summary ("rejected"); they are not
            # scored as served requests. SimCluster never rejects. Each
            # request carries the experiment SLO as its deadline so
            # deadline-aware schedulers (scheduler="edf"/"chunked" on the
            # cluster) and the goodput metric see per-request deadlines.
            cluster.submit(Request(rid=rid, tokens=_NO_TOKENS, max_new=1,
                                   arrival=a, slo_ms=slo_ms), backend)
            cluster.step(a)       # no-op on synchronous backends

    cluster.drain(arrivals[-1] if len(arrivals) else 0.0)
    # Close the audit loop: bucket realized latencies/goodput back onto the
    # controller decisions that governed them (predicted vs measured).
    attach_from_requests(getattr(controller, "audit", None),
                         getattr(cluster, "requests", ()),
                         default_slo_ms=slo_ms)
    summary = cluster.summarize(slo_ms, best_acc)
    return ExperimentResult(name=name, summary=summary,
                            decisions=list(getattr(controller, "decisions", [])))
