"""Discrete-event simulation of the serving cluster.

Each backend (variant, n units) is a c-server FIFO queue whose capacity
matches the profile exactly (Little's law):

    servers c   = max(1, round(th(n) · p(n)))        # concurrency in flight
    service s   = c / th(n)                          # per-request seconds
    => capacity = c / s = th(n), loaded latency ≈ p(n)

mirroring the paper's TF-Serving setup (inter-op parallelism = #cores,
batching off ⇒ concurrency ≈ cores).

Reconfiguration semantics (paper §5, incl. their zero-downtime VPA patch):
  * resizing a *running* variant applies after RESIZE_DELAY_S;
  * a *new* variant warms up until t + rt_m; while warming it receives no
    traffic — its quota spills onto the ready backends (overloading them,
    which is exactly the transient-SLO-violation dynamic the paper reports);
  * an old variant retires only once every newly created backend is ready
    (create-then-remove).

Replica fabric mode (``nodes=``): instead of one monolithic backend per
variant, the allocation materializes as a **placement of replicas across
nodes** via ``repro_torch.cluster.ReplicaFabric`` — each replica is its own
c-server queue (true per-replica queues/servers), requests are routed
two-level (the dispatcher's variant choice, then a ``RoutingAPI`` replica
pick — power-of-two-choices least-outstanding by default), reconfiguration
is rolling create-then-remove at replica granularity, and faults
(``inject_fault``) kill nodes or degrade replicas. A node crash affects
dispatches from the crash instant forward; requests the DES already
scheduled keep their computed completions (synchronous-serve limitation,
noted in DESIGN.md §Cluster fabric).

Scheduling (``scheduler=``): the queue discipline mirrors the real engine's
scheduler layer (DESIGN.md §Scheduling) so controller experiments see the
same queueing semantics in DES and real execution. ``"fifo"`` (default)
serves at submit time in arrival order — the original behavior,
byte-for-byte. ``"edf"``/``"chunked"`` hold arrivals in per-backend
pending heaps and assign them to servers in **earliest-deadline-first**
order at each server-free instant — already-expired deadlines after every
still-feasible one (the engine's expired-last EDF), and only requests
already arrived by that instant are eligible (no lookahead). Chunked
prefill itself is a real-execution concern (DES service times are scalar),
so ``"chunked"`` maps to EDF ordering here; preemption is likewise
engine-only.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set

import numpy as np

from repro_torch.cluster.faults import FaultEvent
from repro_torch.cluster.placement import Node
from repro_torch.cluster.replicas import Replica, ReplicaFabric
from repro_torch.cluster.router import ReplicaView, RoutingAPI, make_router
from repro_torch.core.profiles import VariantProfile
from repro_torch.obs import Observability
from repro_torch.obs import trace as ev
from repro_torch.obs.slo import slo_class_key
from repro_torch.serving.api import Request, summarize_requests
from repro_torch.serving.sched import make_scheduler

RESIZE_DELAY_S = 1.0
# Profiled th(n) is the *SLO-sustained* rate (the paper measures throughput at
# the point where P99 reaches the SLO). The raw service rate at saturation is
# slightly higher; the gap is what lets a backlog drain after a burst.
SERVICE_HEADROOM = 1.35


@dataclass
class Backend:
    profile: VariantProfile
    units: int
    ready_at: float
    retire_at: float = float("inf")
    slow_factor: float = 1.0     # heterogeneity / straggler multiplier
    server_free: List[float] = field(default_factory=list)   # heap

    def __post_init__(self):
        th = self.profile.throughput(self.units)
        p_s = self.profile.p99_ms(self.units) / 1000.0
        c = max(1, int(round(th * p_s)))
        self.capacity = th
        self.service_s = c / max(th * SERVICE_HEADROOM, 1e-9)
        if not self.server_free:
            self.server_free = [self.ready_at] * c
            heapq.heapify(self.server_free)

    def resized(self, n: int, t: float) -> "Backend":
        """Live resize: inherit the in-flight server queue; extra servers come
        online after RESIZE_DELAY_S; shrink keeps the earliest-free servers."""
        nb = Backend(self.profile, n, ready_at=self.ready_at,
                     slow_factor=self.slow_factor)  # resize never un-warms a
        # loading backend nor stalls a ready one
        c_new = len(nb.server_free)
        inherited = sorted(self.server_free)[:c_new]
        while len(inherited) < c_new:
            inherited.append(t + RESIZE_DELAY_S)
        nb.server_free = inherited
        heapq.heapify(nb.server_free)
        return nb

    def ready(self, t: float) -> bool:
        return self.ready_at <= t

    def queue_delay(self, t: float) -> float:
        return max(self.server_free[0] - t, 0.0)

    @property
    def effective_service_s(self) -> float:
        return self.service_s * self.slow_factor

    def outstanding(self, t: float) -> float:
        """Outstanding requests (queued + in service, fractional) — the
        router's least-outstanding signal."""
        s = max(self.effective_service_s, 1e-9)
        return sum(max(f - t, 0.0) for f in self.server_free) / s

    def queued(self, t: float) -> float:
        """Queued-not-in-service requests (the ``ClusterAPI.backlog``
        semantics): per server, whole service times of work beyond the
        request currently in service."""
        s = max(self.effective_service_s, 1e-9)
        return float(sum(int((f - t) / s - 1e-9)
                         for f in self.server_free if f - t > s))

    def serve_timed(self, arrival: float) -> tuple:
        """Grab a server; returns (service_start, completion)."""
        free = heapq.heappop(self.server_free)
        start = max(arrival, free, self.ready_at)
        done = start + self.effective_service_s
        heapq.heappush(self.server_free, done)
        return start, done

    def serve(self, arrival: float) -> float:
        return self.serve_timed(arrival)[1]


@dataclass
class ServedRequest:
    arrival: float
    completion: float
    backend: str
    accuracy: float
    service_start: float = 0.0   # 0.0 = dropped/never served
    slo_ms: float = 0.0          # per-request SLO (goodput metric); <=0=none

    @property
    def latency_ms(self) -> float:
        return (self.completion - self.arrival) * 1000.0

    @property
    def queue_wait_ms(self) -> float:
        if self.service_start <= 0.0:
            return 0.0
        return max(self.service_start - self.arrival, 0.0) * 1000.0

    @property
    def service_ms(self) -> float:
        if self.service_start <= 0.0:
            return self.latency_ms
        return max(self.completion - self.service_start, 0.0) * 1000.0


class SimCluster:
    """Discrete-event implementation of the shared ``ClusterAPI``/
    ``ServingAPI`` (``repro_torch.serving.api``) — the same contract the real
    ``InProcessServingEngine`` implements, so controllers and the experiment
    harness drive either interchangeably.

    Without ``nodes`` the cluster is the paper's setup: one backend per
    variant. With ``nodes`` the replica fabric activates (see module
    docstring): ``placement`` picks the policy (``"first-fit"``/``"spread"``
    or a ``PlacementPolicy``), ``router`` the replica-level routing
    (``"p2c"``/``"least"``/``"rr"``/``"random"`` or a ``RoutingAPI``), and
    ``replica_size`` the max units per replica.
    """

    def __init__(self, profiles: Mapping[str, VariantProfile],
                 nodes: Optional[Sequence[Node]] = None,
                 placement="first-fit", router="p2c",
                 replica_size: int = 4, scheduler="fifo",
                 trace: bool = False, obs: Optional[Observability] = None):
        self.profiles = dict(profiles)
        self.backends: Dict[str, Backend] = {}
        self.requests: List[ServedRequest] = []
        self.cost_samples: List[tuple] = []    # (t, provisioned units)
        # observability parity with the engine (DESIGN.md §Observability):
        # the DES publishes the SAME metric names (requests.*, request.*,
        # router.*) into its registry, and with trace=True stamps lifecycle
        # span events in simulated time — so controller experiments read one
        # metric surface regardless of backend. Simulated requests have no
        # ticks, so the DES emits no TickRecords.
        self.obs = obs if obs is not None else Observability(trace=trace)
        self.metrics = self.obs.metrics
        self.tracer = self.obs.tracer
        # rolling windows (obs.windows): fed at completion in _record with
        # the SAME names as the engine's _obs_complete, keyed by virtual
        # time — burn-rate monitors read either backend identically
        self.windows = self.obs.windows
        # queue discipline mirroring the engine's scheduler layer (module
        # docstring): "fifo" serves at submit; "edf"/"chunked" hold arrivals
        # in per-backend pending heaps assigned deadline-first
        self.sched = make_scheduler(scheduler)
        self._edf = self.sched.name != "fifo"
        # per backend key: two heaps of (deadline, seq, arrival, slo_ms,
        # rid) — still-feasible vs already-expired entries (the engine's EDF
        # serves expired requests LAST; see _flush_pending) — plus an
        # arrival heap and a live-seq set for lazy deletion (seq is unique,
        # so heap comparison never reaches the trailing rid)
        self._pending: Dict[str, Dict[str, object]] = {}
        self._pseq = itertools.count()
        self.fabric: Optional[ReplicaFabric] = None
        self.router: Optional[RoutingAPI] = None
        if nodes is not None:
            self.fabric = ReplicaFabric(
                nodes, policy=placement, replica_size=replica_size,
                rt_fn=lambda m: self.profiles[m].rt)
            self.router = make_router(router, metrics=self.metrics)

    # ------------------------------------------------------------- ClusterAPI
    def apply_allocation(self, t: float, units: Mapping[str, int]) -> None:
        if self.fabric is not None:
            self._apply_fabric(t, units)
            return
        target = {m: n for m, n in units.items() if n > 0}
        new_ready = [t]
        for m, n in target.items():
            b = self.backends.get(m)
            if b is not None:
                b.retire_at = float("inf")   # re-selected: cancel retirement
                if b.units != n:
                    self.backends[m] = b.resized(n, t)
                new_ready.append(self.backends[m].ready_at)
            else:
                nb = Backend(self.profiles[m], n, ready_at=t + self.profiles[m].rt)
                self.backends[m] = nb
                new_ready.append(nb.ready_at)
        switch_t = max(new_ready)
        for m, b in self.backends.items():
            if m not in target:
                b.retire_at = min(b.retire_at, switch_t)
        self.cost_samples.append(
            (t, sum(b.units for b in self.backends.values()
                    if b.retire_at == float("inf"))))

    def _apply_fabric(self, t: float, units: Mapping[str, int]) -> None:
        self.fabric.purge(t)
        tr = self.fabric.apply(t, units)
        for rep in tr.created:
            self._attach_handle(rep)
        for rep in tr.retired:
            rep.handle.retire_at = rep.retire_at
        self.cost_samples.append((t, self.fabric.provisioned_units()))

    def _attach_handle(self, rep: Replica) -> None:
        b = Backend(self.profiles[rep.variant], rep.units,
                    ready_at=rep.ready_at, slow_factor=rep.slow_factor)
        rep.handle = b

    def loaded_variants(self, t: float) -> Set[str]:
        if self.fabric is not None:
            return set(self.fabric.variants_ready(t))
        return {m for m, b in self.backends.items() if b.ready(t)}

    def backlog(self, t: float) -> float:
        """Queued-not-in-service requests (shared ``ClusterAPI`` semantics:
        admitted work not yet being processed — see ``serving/api.py``).
        Under deadline-aware scheduling, still-pending (unassigned) requests
        count too — they are admitted work waiting for a server."""
        if self.fabric is not None:
            return sum(r.handle.queued(t) for r in self.fabric.replicas.values()
                       if r.live(t)) + self._pending_depth()
        return sum(b.queued(t) for b in self.backends.values()
                   if b.retire_at > t) + self._pending_depth()

    def capacity_factor(self, t: float) -> float:
        """Fraction of the target allocation actually live (1.0 without a
        fabric — monolithic backends don't fail)."""
        return self.fabric.capacity_factor(t) if self.fabric is not None else 1.0

    def mark_warm(self, variants: Optional[Sequence[str]] = None,
                  t: float = 0.0) -> None:
        """Force readiness at ``t`` (experiment-harness warm start; call
        before traffic — it also clears the warm-up hold on each server)."""
        def warm(b: Backend) -> None:
            b.ready_at = min(b.ready_at, t)
            b.server_free = [min(f, t) for f in b.server_free]
            heapq.heapify(b.server_free)
        if self.fabric is not None:
            self.fabric.mark_ready(t, variants)
            for r in self.fabric.replicas.values():
                if variants is None or r.variant in variants:
                    warm(r.handle)
            return
        for m, b in self.backends.items():
            if variants is None or m in variants:
                warm(b)

    # ----------------------------------------------------------------- faults
    def inject_fault(self, t: float, event: FaultEvent) -> None:
        """Apply one ``repro_torch.cluster.faults`` event (fabric mode only)."""
        if self.fabric is None:
            raise RuntimeError("fault injection requires the replica fabric "
                               "(construct SimCluster with nodes=)")
        if event.kind == "node_crash":
            self.fabric.crash_node(t, event.target)
        elif event.kind == "node_recover":
            self.fabric.recover_node(t, event.target)
        elif event.kind in ("replica_slowdown", "replica_restore"):
            factor = event.factor if event.kind == "replica_slowdown" else 1.0
            if self.fabric.slow_replica(t, event.target, factor):
                rep = self.fabric.replicas[event.target]
                rep.handle.slow_factor = rep.slow_factor
        if self.obs.flight is not None:
            self.obs.flight.trigger(f"fault_{event.kind}", t,
                                    extra={"target": event.target,
                                           "factor": event.factor})

    # ---------------------------------------------------------------- serving
    def submit(self, req: Request, backend: Optional[str]) -> bool:
        """ServingAPI parity with the real engine: a simulated request needs
        only its arrival time (and SLO, for deadline-aware scheduling) —
        prompt tokens don't affect queueing."""
        self.dispatch(req.arrival, backend or None, slo_ms=req.slo_ms,
                      rid=req.rid)
        return True

    def _record(self, sr: ServedRequest, rid: Optional[int] = None) -> None:
        """The ONE sink for served requests: append + publish the same
        registry metrics the engine's ``_obs_complete`` emits, and (tracing
        on, rid known) the queued/admitted/complete span events in simulated
        time. ``service_start == 0`` marks a request the DES never served
        (no live backend) — counted as dropped, mirroring engine drops."""
        self.requests.append(sr)
        m = self.metrics
        m.inc("requests.completed")
        lat = sr.latency_ms
        m.observe("request.latency_ms", lat)
        m.observe("request.queue_wait_ms", sr.queue_wait_ms)
        m.observe("request.service_ms", sr.service_ms)
        dropped = sr.service_start <= 0.0
        good = not dropped and (sr.slo_ms <= 0 or lat <= sr.slo_ms)
        if dropped:
            m.inc("requests.dropped")
        elif good:
            m.inc("requests.goodput_ok")
        w = self.windows
        if w.on:     # windowed mirror of the above, keyed at virtual time
            tc = sr.completion
            w.inc("requests.completed", tc)
            w.observe("request.latency_ms", tc, lat)
            cls = slo_class_key(sr.slo_ms)
            if dropped:
                w.inc("requests.dropped", tc)
            elif good:
                w.inc("requests.goodput_ok", tc)
            w.inc(f"slo.class.{cls}.{'good' if good else 'bad'}", tc)
        if self.tracer.on and rid is not None:
            self.tracer.event(rid, ev.QUEUED, sr.arrival, backend=sr.backend)
            if sr.service_start > 0.0:
                self.tracer.event(rid, ev.ADMITTED, sr.service_start,
                                  backend=sr.backend)
            self.tracer.event(rid, ev.COMPLETE, sr.completion,
                              backend=sr.backend, latency_ms=lat)

    def step(self, now: float) -> int:
        """No-op: the DES serves synchronously at submit time."""
        return 0

    def drain(self, now: float) -> int:
        """FIFO: no-op (nothing is left in flight between submits). EDF:
        assign every still-pending request to its backend's servers."""
        if not self._edf:
            return 0
        n0 = len(self.requests)
        self._flush_all()
        return len(self.requests) - n0

    # ----------------------------------------- deadline-aware pending queues
    @staticmethod
    def _pop_eligible(heap: List[tuple], live: set, t: float):
        """Earliest-deadline entry with ``arrival <= t``, removed from the
        heap; None if no such entry. Dead (already-assigned) tops are
        dropped lazily. A top that arrived after ``t`` falls back to a
        linear scan — rare, because flushes run at every dispatch so pending
        arrivals almost always precede the assignment instant."""
        while heap and heap[0][1] not in live:
            heapq.heappop(heap)
        if not heap:
            return None
        if heap[0][2] <= t:
            return heapq.heappop(heap)
        elig = [e for e in heap if e[1] in live and e[2] <= t]
        if not elig:
            return None
        e = min(elig)
        heap.remove(e)
        heapq.heapify(heap)
        return e

    def _flush_pending(self, key: str, b: Backend, upto: float,
                       accuracy: float) -> None:
        """Assign pending requests to ``b``'s servers up to time ``upto``.
        At each assignment instant — the later of the earliest-free server
        and the earliest pending arrival — the earliest-deadline request
        *already arrived by that instant* is served, with already-expired
        deadlines served after every still-feasible one (the engine's
        ``_edf_key`` semantics: spending a server on a hopeless request
        before a feasible one converts one violation into two). No
        lookahead: later arrivals were not in the queue when the server
        came free, whatever their deadline."""
        pend = self._pending.get(key)
        if not pend:
            return
        feas, exp, arr, live = (pend["feas"], pend["exp"], pend["arr"],
                                pend["live"])
        while live:
            t_free = max(b.server_free[0], b.ready_at)
            while arr and arr[0][1] not in live:
                heapq.heappop(arr)
            t_assign = max(t_free, arr[0][0])
            if t_assign > upto:
                break
            # deadlines that have passed by the assignment instant migrate
            # to the expired heap (one-way: t_assign is non-decreasing)
            while feas:
                if feas[0][1] not in live:
                    heapq.heappop(feas)
                elif feas[0][0] <= t_assign:
                    heapq.heappush(exp, heapq.heappop(feas))
                else:
                    break
            e = self._pop_eligible(feas, live, t_assign)
            if e is None:
                e = self._pop_eligible(exp, live, t_assign)
            assert e is not None   # the min-arrival live entry is eligible
            live.discard(e[1])
            start, done = b.serve_timed(e[2])
            self._record(ServedRequest(e[2], done, key, accuracy,
                                       service_start=start, slo_ms=e[3]),
                         rid=e[4])

    def _enqueue_pending(self, key: str, arrival: float, slo_ms: float,
                         rid: Optional[int] = None) -> None:
        dl = arrival + slo_ms / 1000.0 if slo_ms > 0 else float("inf")
        pend = self._pending.setdefault(
            key, {"feas": [], "exp": [], "arr": [], "live": set()})
        seq = next(self._pseq)
        heapq.heappush(pend["feas"], (dl, seq, arrival, slo_ms, rid))
        heapq.heappush(pend["arr"], (arrival, seq))
        pend["live"].add(seq)

    def _flush_all(self) -> None:
        for key, pend in self._pending.items():
            if not pend["live"]:
                continue
            if self.fabric is not None:
                rep = self.fabric.replicas.get(key)
                if rep is not None and rep.handle is not None:
                    self._flush_pending(key, rep.handle, float("inf"),
                                        self.profiles[rep.variant].accuracy)
                    continue
            elif key in self.backends:
                b = self.backends[key]
                self._flush_pending(key, b, float("inf"), b.profile.accuracy)
                continue
            live = pend["live"]          # backend gone: orphaned pendings
            for e in list(pend["feas"]) + list(pend["exp"]):
                if e[1] in live:
                    self._record(ServedRequest(e[2], e[2] + 10.0,
                                               "none", 0.0, slo_ms=e[3]),
                                 rid=e[4])
            pend["feas"].clear()
            pend["exp"].clear()
            pend["arr"].clear()
            live.clear()

    def _pending_depth(self) -> float:
        return float(sum(len(p["live"]) for p in self._pending.values()))

    def _purge(self, t: float) -> None:
        for m in [m for m, b in self.backends.items() if b.retire_at <= t]:
            b = self.backends[m]
            # a retiring backend first serves what was assigned to it —
            # accepted work is never dropped by a switch (engine parity)
            self._flush_pending(m, b, float("inf"), b.profile.accuracy)
            del self.backends[m]

    def dispatch(self, arrival: float, backend_name: Optional[str],
                 slo_ms: float = 0.0, rid: Optional[int] = None) -> None:
        self.metrics.inc("requests.submitted")
        if self.windows.on:
            self.windows.inc("requests.submitted", arrival)
        if self.fabric is not None:
            self._dispatch_fabric(arrival, backend_name, slo_ms, rid=rid)
            return
        self._purge(arrival)
        candidates = {m: b for m, b in self.backends.items()
                      if b.retire_at > arrival}
        if not candidates:
            self._record(ServedRequest(arrival, arrival + 10.0,
                                       "none", 0.0, slo_ms=slo_ms), rid=rid)
            return
        b = candidates.get(backend_name) if backend_name else None
        if b is None or not b.ready(arrival):
            ready = {m: bb for m, bb in candidates.items() if bb.ready(arrival)}
            pool = ready or candidates
            name = min(pool, key=lambda m: pool[m].queue_delay(arrival))
            b = pool[name]
            backend_name = name
        if self._edf:
            self._enqueue_pending(backend_name, arrival, slo_ms, rid=rid)
            self._flush_pending(backend_name, b, arrival, b.profile.accuracy)
            return
        start, done = b.serve_timed(arrival)
        self._record(ServedRequest(arrival, done, backend_name,
                                   b.profile.accuracy, service_start=start,
                                   slo_ms=slo_ms), rid=rid)

    # ----------------------------------------------------- two-level routing
    def _pick_replica(self, variant: str, arrival: float) -> Optional[Replica]:
        """Level 2 of two-level routing: the ``RoutingAPI`` picks among the
        variant's ready replicas (fall back to warming ones — service then
        waits for readiness, the same spill the monolithic sim models)."""
        reps = self.fabric.ready_replicas(variant, arrival) or \
            [r for r in self.fabric.group(variant) if r.live(arrival)]
        if not reps:
            return None
        views = [ReplicaView(r.rid, r.handle.outstanding(arrival), r.units)
                 for r in reps]
        rid = self.router.pick(views)
        return self.fabric.replicas[rid]

    def _dispatch_fabric(self, arrival: float, backend_name: Optional[str],
                         slo_ms: float = 0.0,
                         rid: Optional[int] = None) -> None:
        self.fabric.purge(arrival)
        live = [r for r in self.fabric.replicas.values() if r.live(arrival)]
        if not live:
            self._record(ServedRequest(arrival, arrival + 10.0,
                                       "none", 0.0, slo_ms=slo_ms), rid=rid)
            return
        variant = backend_name
        ready = [r for r in live if r.ready(arrival)]
        if variant is None or not any(r.variant == variant for r in ready):
            # dispatcher quota points at a warming/retired/unknown variant:
            # spill to the ready variant whose best replica frees first
            # (legacy fallback — the transient-overload dynamic of §5)
            pool = ready or live
            variant = min(pool,
                          key=lambda r: r.handle.queue_delay(arrival)).variant
        rep = self._pick_replica(variant, arrival)
        if self._edf:
            self._enqueue_pending(rep.rid, arrival, slo_ms, rid=rid)
            self._flush_pending(rep.rid, rep.handle, arrival,
                                self.profiles[rep.variant].accuracy)
            return
        start, done = rep.handle.serve_timed(arrival)
        self._record(ServedRequest(
            arrival, done, rep.rid, self.profiles[rep.variant].accuracy,
            service_start=start, slo_ms=slo_ms), rid=rid)

    def dispatch_fanout(self, arrival: float, backend_names, accuracy: float
                        ) -> None:
        """Cocktail-style ensembling: the request runs on EVERY member;
        latency is the slowest member (majority vote needs all of them)."""
        if self.fabric is not None:
            self._dispatch_fanout_fabric(arrival, backend_names, accuracy)
            return
        self._purge(arrival)
        done = arrival + 10.0
        served = False
        start = 0.0
        for name in backend_names:
            b = self.backends.get(name)
            if b is None or b.retire_at <= arrival:
                continue
            s, d = b.serve_timed(arrival)
            done = max(done if served else arrival, d)
            start = min(start, s) if served else s   # earliest member start
            served = True
        if not served:
            self.dispatch(arrival, None)
            return
        self.metrics.inc("requests.submitted")
        if self.windows.on:
            self.windows.inc("requests.submitted", arrival)
        self._record(ServedRequest(arrival, done, "+".join(backend_names),
                                   accuracy, service_start=start))

    def _dispatch_fanout_fabric(self, arrival: float, backend_names,
                                accuracy: float) -> None:
        self.fabric.purge(arrival)
        done = arrival + 10.0
        served = False
        start = 0.0
        members = []
        for name in backend_names:
            rep = self._pick_replica(name, arrival)
            if rep is None:
                continue
            s, d = rep.handle.serve_timed(arrival)
            done = max(done if served else arrival, d)
            start = min(start, s) if served else s
            served = True
            members.append(rep.rid)
        if not served:
            self.dispatch(arrival, None)
            return
        self.metrics.inc("requests.submitted")
        if self.windows.on:
            self.windows.inc("requests.submitted", arrival)
        self._record(ServedRequest(arrival, done, "+".join(members),
                                   accuracy, service_start=start))

    # ---------------------------------------------------------------- metrics
    def summarize(self, slo_ms: float, best_accuracy: float,
                  window_s: float = 10.0) -> Dict:
        """Paper evaluation summary (§6) via the shared metric helper."""
        if self._edf:
            self._flush_all()            # score still-pending work too
        return summarize_requests(
            [r.arrival for r in self.requests],
            [r.latency_ms for r in self.requests],
            [r.accuracy for r in self.requests],
            slo_ms=slo_ms, best_accuracy=best_accuracy,
            cost_samples=self.cost_samples, window_s=window_s,
            queue_ms=[r.queue_wait_ms for r in self.requests],
            service_ms=[r.service_ms for r in self.requests],
            slo_list_ms=[r.slo_ms for r in self.requests])
