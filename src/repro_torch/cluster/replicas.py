"""ReplicaGroup bookkeeping: allocation units -> placed replicas, with
rolling create-then-remove reconfiguration.

``ReplicaFabric`` is the backend-agnostic half of the cluster fabric: it
owns the node inventory, per-variant replica groups, placement, and the
paper's §5 reconfiguration semantics lifted to replica granularity. Both
serving backends (``repro.sim.cluster.SimCluster`` and
``repro.serving.engine.InProcessServingEngine``) delegate to one fabric and
attach their own execution object to each replica via ``Replica.handle``
(a DES ``Backend`` with its own server heap, or a real ``VariantBackend``
with its own slots and admission queue).

Reconfiguration is **staggered create-then-remove**: ``apply`` diffs the
target replica multiset against the live group, creates missing replicas
(ready after rt_m), and schedules surplus replicas to retire only at
``switch_t`` — the moment every newly created replica (cluster-wide) is
ready. Capacity therefore never dips below the old allocation during a
transition; the surge is real (old + new co-resident), so placement charges
retiring replicas against node capacity until they purge.

Fault surface: ``crash_node`` kills every replica on a node immediately
(no drain — it crashed), ``recover_node`` returns capacity,
``slow_replica``/``restore_replica`` scale one replica's service rate.
Re-placement after a fault flows *through the controller*: the next
``apply_allocation`` re-diffs and re-places, and ``capacity_factor`` tells
reactive controllers how much of the target allocation is actually live so
they re-solve without waiting for the interval boundary.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.cluster.placement import (Node, Placement, ReplicaSpec,
                                     make_placement_policy, replica_sizes)

__all__ = ["Replica", "Transition", "ReplicaFabric"]


@dataclass
class Replica:
    """One placed replica: spec + lifecycle + the backend execution object."""
    spec: ReplicaSpec
    ready_at: float
    retire_at: float = float("inf")
    slow_factor: float = 1.0     # service-time multiplier (node speed, faults)
    crashed: bool = False
    handle: Any = None           # backend-owned execution state

    @property
    def rid(self) -> str:
        return self.spec.rid

    @property
    def variant(self) -> str:
        return self.spec.variant

    @property
    def units(self) -> int:
        return self.spec.units

    @property
    def node_id(self) -> str:
        return self.spec.node_id

    def ready(self, t: float) -> bool:
        return self.ready_at <= t < self.retire_at

    def live(self, t: float) -> bool:
        return self.retire_at > t


@dataclass
class Transition:
    """What one ``apply`` changed (backends act on created/retired)."""
    created: List[Replica] = field(default_factory=list)
    retired: List[Replica] = field(default_factory=list)
    switch_t: float = 0.0
    shortfall: Dict[str, int] = field(default_factory=dict)


class ReplicaFabric:
    """Node inventory + per-variant replica groups + rolling transitions."""

    def __init__(self, nodes: Sequence[Node], *, policy="first-fit",
                 replica_size: int = 1,
                 rt_fn: Callable[[str], float] = lambda m: 0.0):
        self.nodes: Dict[str, Node] = {n.node_id: n for n in nodes}
        self.policy = make_placement_policy(policy)
        self.replica_size = max(1, int(replica_size))
        self.rt_fn = rt_fn
        self.replicas: Dict[str, Replica] = {}
        self.target_units: Dict[str, int] = {}
        self.shortfall: Dict[str, int] = {}
        self._next_idx: Dict[str, int] = {}

    # ------------------------------------------------------------ inventory
    def group(self, variant: str) -> List[Replica]:
        return [r for r in self.replicas.values() if r.variant == variant]

    def ready_replicas(self, variant: str, t: float) -> List[Replica]:
        return sorted((r for r in self.group(variant) if r.ready(t)),
                      key=lambda r: r.rid)

    def variants_ready(self, t: float) -> List[str]:
        return sorted({r.variant for r in self.replicas.values() if r.ready(t)})

    def used_units(self) -> Dict[str, int]:
        """Units occupied per node by every non-purged replica — retiring
        replicas still hold their slot (surge semantics)."""
        used: Dict[str, int] = {}
        for r in self.replicas.values():
            used[r.node_id] = used.get(r.node_id, 0) + r.units
        return used

    def purge(self, t: float) -> List[Replica]:
        """Drop replicas whose retirement time has passed; returns them so
        the backend can free execution state."""
        gone = [r for r in self.replicas.values() if r.retire_at <= t]
        for r in gone:
            del self.replicas[r.rid]
        return gone

    # ----------------------------------------------------------- transitions
    def apply(self, t: float, units: Mapping[str, int]) -> Transition:
        """Rolling reconfiguration to ``units`` (variant -> total units).

        Target replica sizes come from ``replica_sizes``; existing replicas
        matching a target size are kept in place (no churn; a scheduled
        retirement is cancelled), missing ones are created and placed,
        surplus ones retire at ``switch_t`` = max readiness of all creates.
        """
        target = {m: n for m, n in units.items() if n > 0}
        self.target_units = dict(target)
        tr = Transition()
        to_place: List[ReplicaSpec] = []
        kept: List[Replica] = []
        surplus: List[Replica] = []
        for m, n in target.items():
            pool = [r for r in self.group(m) if not r.crashed]
            # ready replicas match first so a transition never trades a warm
            # replica for a cold one of the same size
            pool.sort(key=lambda r: (r.ready_at, r.rid))
            for size in replica_sizes(n, self.replica_size):
                hit = next((r for r in pool if r.units == size), None)
                if hit is not None:
                    pool.remove(hit)
                    kept.append(hit)
                else:
                    idx = self._next_idx.get(m, 0)
                    self._next_idx[m] = idx + 1
                    to_place.append(ReplicaSpec(m, idx, size))
            surplus.extend(pool)
        for m in {r.variant for r in self.replicas.values()}:
            if m not in target:
                surplus.extend(r for r in self.group(m) if not r.crashed)

        placement = self.policy.place(list(self.nodes.values()), to_place,
                                      self.used_units())
        self.shortfall = dict(placement.shortfall)
        for spec in placement.placed:
            node = self.nodes[spec.node_id]
            rep = Replica(spec, ready_at=t + self.rt_fn(spec.variant),
                          slow_factor=1.0 / max(node.speed, 1e-9))
            self.replicas[rep.rid] = rep
            tr.created.append(rep)

        tr.switch_t = max([t] + [r.ready_at for r in tr.created])
        for r in kept:
            r.retire_at = float("inf")       # re-selected: cancel retirement
        for r in surplus:
            r.retire_at = min(r.retire_at, tr.switch_t)
            tr.retired.append(r)
        tr.shortfall = dict(placement.shortfall)
        return tr

    def mark_ready(self, t: float = 0.0,
                   variants: Optional[Sequence[str]] = None) -> None:
        """Force readiness (warm-start support in the experiment harness)."""
        for r in self.replicas.values():
            if variants is None or r.variant in variants:
                r.ready_at = min(r.ready_at, t)

    # ------------------------------------------------------------ capacity
    def live_units(self, t: float) -> int:
        return sum(r.units for r in self.replicas.values()
                   if r.live(t) and not r.crashed
                   and self.nodes[r.node_id].alive)

    def provisioned_units(self) -> int:
        """Cost accounting parity with the non-replicated backends: units of
        replicas not scheduled for retirement."""
        return sum(r.units for r in self.replicas.values()
                   if r.retire_at == float("inf"))

    def capacity_factor(self, t: float) -> float:
        """Fraction of the target allocation actually live (placed on an
        alive node, not crashed/retired; warming counts — it is coming).
        Reactive controllers multiply provisioned capacity by this, so a
        node crash or placement shortfall triggers an immediate re-solve."""
        target = sum(self.target_units.values())
        if target <= 0:
            return 1.0
        return min(1.0, self.live_units(t) / target)

    # -------------------------------------------------------------- faults
    def crash_node(self, t: float, node_id: str) -> List[Replica]:
        """Node failure: every replica on it dies NOW (no drain). Returns
        the killed replicas so the backend can recover their requests."""
        node = self.nodes[node_id]
        node.alive = False
        killed = [r for r in self.replicas.values()
                  if r.node_id == node_id and r.live(t)]
        for r in killed:
            r.crashed = True
            r.retire_at = t
        return killed

    def recover_node(self, t: float, node_id: str) -> None:
        """Node back: capacity is available again; replicas return only via
        the next placement (controller-driven re-placement)."""
        self.nodes[node_id].alive = True

    def slow_replica(self, t: float, rid: str, factor: float) -> bool:
        """Degrade one replica's service rate by ``factor`` (≥1). Returns
        False when the rid no longer exists (retired/crashed before the
        event fired — stale fault events are no-ops, not crashes)."""
        r = self.replicas.get(rid)
        if r is None:
            return False
        node = self.nodes[r.node_id]
        r.slow_factor = max(factor, 1.0) / max(node.speed, 1e-9)
        return True

    def restore_replica(self, t: float, rid: str) -> bool:
        return self.slow_replica(t, rid, 1.0)
