"""Replica-level routing: the second level of two-level routing.

Level 1 is the paper's dispatcher — smooth weighted round-robin over
*variants*, proportional to the solver's quotas λ_m
(``repro.core.dispatcher.WeightedRoundRobinDispatcher``). This module is
level 2: once the variant is chosen, a ``RoutingAPI`` implementation picks
the *replica*. Both serving backends route through the same interface, so
routing policy is a constructor argument, not backend code.

The default is **power-of-two-choices least-outstanding** (``p2c``): sample
two distinct replicas, send to the one with fewer outstanding requests per
unit (normalizing by units keeps heterogeneous replica sizes fair). The
classic balls-into-bins result — two choices collapse the max/mean load
ratio from Θ(log n / log log n) to Θ(log log n) — holds under queueing too
(Mitzenmacher '01), and unlike full least-outstanding (``least``) it needs
O(1) state reads per request. ``rr``/``random`` are the WRR-only baselines
``benchmarks/bench_cluster.py`` compares against: replica choice blind to
load, which is exactly what a quota-weighted WRR alone gives you.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = ["ReplicaView", "RoutingAPI", "PowerOfTwoChoicesRouter",
           "LeastOutstandingRouter", "RoundRobinReplicaRouter",
           "RandomReplicaRouter", "InstrumentedRouter", "ROUTERS",
           "make_router"]


@dataclass
class ReplicaView:
    """What a router may see about one candidate replica."""
    rid: str
    outstanding: float          # queued + in-service requests on the replica
    units: int = 1              # per-replica allocation (capacity weight)

    @property
    def load(self) -> float:
        """Outstanding per unit — the least-loaded comparison key."""
        return self.outstanding / max(self.units, 1)


@runtime_checkable
class RoutingAPI(Protocol):
    """Replica picker: candidates are the chosen variant's ready replicas."""

    def pick(self, replicas: Sequence[ReplicaView]) -> Optional[str]:
        """Return the rid to route to, or None when no candidate exists."""
        ...


class PowerOfTwoChoicesRouter:
    """Sample two distinct replicas, pick the less-loaded (ties: lower rid)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def pick(self, replicas: Sequence[ReplicaView]) -> Optional[str]:
        if not replicas:
            return None
        if len(replicas) == 1:
            return replicas[0].rid
        i, j = self._rng.choice(len(replicas), size=2, replace=False)
        a, b = replicas[int(i)], replicas[int(j)]
        return min((a, b), key=lambda r: (r.load, r.rid)).rid


class LeastOutstandingRouter:
    """Full scan join-the-shortest-queue (upper bound on p2c's benefit)."""

    def pick(self, replicas: Sequence[ReplicaView]) -> Optional[str]:
        if not replicas:
            return None
        return min(replicas, key=lambda r: (r.load, r.rid)).rid


class RoundRobinReplicaRouter:
    """Load-blind cycling — the deterministic WRR-only baseline. Cycles
    per variant (rid prefix before ``#``): interleaved traffic to other
    variants must not break a variant's own rotation."""

    def __init__(self):
        self._i: dict = {}

    def pick(self, replicas: Sequence[ReplicaView]) -> Optional[str]:
        if not replicas:
            return None
        ordered = sorted(replicas, key=lambda r: r.rid)
        key = ordered[0].rid.rsplit("#", 1)[0]
        i = self._i.get(key, 0)
        self._i[key] = i + 1
        return ordered[i % len(ordered)].rid


class RandomReplicaRouter:
    """Load-blind uniform choice — the stateless WRR-only baseline."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def pick(self, replicas: Sequence[ReplicaView]) -> Optional[str]:
        if not replicas:
            return None
        return replicas[int(self._rng.integers(len(replicas)))].rid


class InstrumentedRouter:
    """Delegating wrapper that publishes routing decisions into a metrics
    registry (``repro.obs``): total picks, picks with no candidate, and a
    histogram of the chosen replica's load — enough to see whether level-2
    routing is actually balancing without threading counters by hand."""

    def __init__(self, inner: RoutingAPI, metrics):
        self.inner = inner
        self.metrics = metrics

    def pick(self, replicas: Sequence[ReplicaView]) -> Optional[str]:
        rid = self.inner.pick(replicas)
        m = self.metrics
        if rid is None:
            m.inc("router.no_candidate")
            return None
        m.inc("router.picks")
        for r in replicas:
            if r.rid == rid:
                m.observe("router.picked_load", r.load)
                break
        return rid


ROUTERS = {"p2c": PowerOfTwoChoicesRouter, "least": LeastOutstandingRouter,
           "rr": RoundRobinReplicaRouter, "random": RandomReplicaRouter}


def make_router(router, metrics=None) -> RoutingAPI:
    """Accept a router name or an instance (pluggable routing). With a
    ``metrics`` registry, the router is wrapped in ``InstrumentedRouter``
    so every pick lands in the engine-wide registry."""
    if isinstance(router, str):
        try:
            router = ROUTERS[router]()
        except KeyError:
            raise ValueError(f"unknown router {router!r} "
                             f"(available: {sorted(ROUTERS)})")
    if metrics is not None and getattr(metrics, "enabled", False):
        return InstrumentedRouter(router, metrics)
    return router
