"""Nodes and placement policies: allocation units -> node->replica map.

The paper's Eq. 1 solver outputs a *vertical* allocation (variant -> n
resource units); production clusters (INFaaS, arXiv 1905.13348; Cocktail)
realise that allocation *horizontally* as replicas spread over nodes. This
module owns the horizontal step:

  * ``Node`` — one machine with ``capacity_units`` and an optional
    heterogeneity ``speed`` factor (a 0.5-speed node runs every replica
    placed on it at half rate — the fabric turns this into a per-replica
    ``slow_factor``);
  * ``replica_sizes`` — split n units into per-replica allocations of at
    most ``replica_size`` units (the per-replica concurrency the profiler's
    units->slots mapping assumes);
  * placement policies — ``FirstFitPlacement`` (bin-packing: fewest nodes)
    and ``SpreadPlacement`` (most free capacity first: failure-domain
    spreading), both behind ``PlacementPolicy``.

Infeasible placements are **rejected or repaired**: with ``strict=True`` a
replica that fits on no alive node raises ``PlacementError``; otherwise the
policy repairs by shrinking the replica to the largest free slot (recorded
as ``Placement.shortfall`` units so callers — and ``capacity_factor`` — see
exactly what was not provisioned).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Protocol, Sequence

__all__ = ["Node", "ReplicaSpec", "Placement", "PlacementError",
           "PlacementPolicy", "FirstFitPlacement", "SpreadPlacement",
           "PLACEMENT_POLICIES", "make_placement_policy", "replica_sizes",
           "make_nodes"]


class PlacementError(RuntimeError):
    """A replica fits on no alive node (strict placement only)."""


@dataclass
class Node:
    """One machine in the cluster: a bin of resource units.

    ``speed`` is the heterogeneity factor (1.0 = reference hardware); the
    fabric assigns replicas on this node ``slow_factor = 1/speed``."""
    node_id: str
    capacity_units: int
    speed: float = 1.0
    alive: bool = True

    def free_units(self, used: Mapping[str, int]) -> int:
        return self.capacity_units - used.get(self.node_id, 0)


@dataclass
class ReplicaSpec:
    """One replica-to-be: (variant, index) identity + size + node."""
    variant: str
    index: int
    units: int
    node_id: str = ""

    @property
    def rid(self) -> str:
        return f"{self.variant}#{self.index}"


@dataclass
class Placement:
    """Result of placing a batch of replica specs onto nodes."""
    placed: List[ReplicaSpec] = field(default_factory=list)
    shortfall: Dict[str, int] = field(default_factory=dict)  # variant -> units

    @property
    def feasible(self) -> bool:
        return not self.shortfall


def replica_sizes(units: int, replica_size: int) -> List[int]:
    """Split an allocation of ``units`` into per-replica sizes ≤
    ``replica_size``, as evenly as possible (largest first) — e.g.
    ``replica_sizes(5, 2) == [2, 2, 1]``. The solver's "n units" becomes
    "len(sizes) replicas" with per-replica concurrency ``sizes[i]``."""
    if units <= 0:
        return []
    r = max(1, int(replica_size))
    k = -(-units // r)                       # ceil
    base, extra = divmod(units, k)
    return [base + 1] * extra + [base] * (k - extra)


def make_nodes(n: int, capacity_units: int, speeds: Sequence[float] = (),
               ) -> List[Node]:
    """Convenience constructor: ``n`` nodes named node0..node{n-1}."""
    return [Node(f"node{i}", capacity_units,
                 speed=(speeds[i] if i < len(speeds) else 1.0))
            for i in range(n)]


class PlacementPolicy(Protocol):
    """Turns replica specs into a node assignment given current usage."""

    def place(self, nodes: Sequence[Node], specs: Sequence[ReplicaSpec],
              used: Mapping[str, int], *, strict: bool = False) -> Placement:
        """Assign ``spec.node_id`` for each spec. ``used`` maps node_id ->
        units already occupied (by live AND retiring replicas — rolling
        create-then-remove needs surge capacity). Repairs by shrinking when
        a spec fits nowhere, unless ``strict``."""
        ...


class _GreedyPlacement:
    """Shared greedy skeleton: subclasses order candidate nodes."""

    def _order(self, nodes: List[Node], free: Dict[str, int]) -> List[Node]:
        raise NotImplementedError

    def place(self, nodes: Sequence[Node], specs: Sequence[ReplicaSpec],
              used: Mapping[str, int], *, strict: bool = False) -> Placement:
        alive = [n for n in nodes if n.alive]
        free = {n.node_id: n.free_units(used) for n in alive}
        out = Placement()
        for spec in sorted(specs, key=lambda s: (-s.units, s.variant, s.index)):
            cands = [n for n in self._order(alive, free)
                     if free[n.node_id] >= spec.units]
            if cands:
                spec.node_id = cands[0].node_id
                free[spec.node_id] -= spec.units
                out.placed.append(spec)
                continue
            # reject or repair: shrink to the largest free slot (≥1 unit)
            best = max(alive, key=lambda n: free[n.node_id], default=None)
            avail = free[best.node_id] if best is not None else 0
            if avail <= 0:
                if strict:
                    raise PlacementError(
                        f"replica {spec.rid} ({spec.units}u) fits on no "
                        f"alive node")
                out.shortfall[spec.variant] = (
                    out.shortfall.get(spec.variant, 0) + spec.units)
                continue
            if strict:
                raise PlacementError(
                    f"replica {spec.rid} needs {spec.units}u, best free "
                    f"slot is {avail}u on {best.node_id}")
            out.shortfall[spec.variant] = (
                out.shortfall.get(spec.variant, 0) + spec.units - avail)
            spec.units = avail
            spec.node_id = best.node_id
            free[best.node_id] -= avail
            out.placed.append(spec)
        return out


class FirstFitPlacement(_GreedyPlacement):
    """First-fit decreasing bin-packing: fill nodes in id order — fewest
    nodes touched (cheap to drain idle nodes)."""

    def _order(self, nodes: List[Node], free: Dict[str, int]) -> List[Node]:
        return sorted(nodes, key=lambda n: n.node_id)


class SpreadPlacement(_GreedyPlacement):
    """Spread-across-nodes: most free capacity first — maximizes failure
    domains (a node crash kills the fewest replicas)."""

    def _order(self, nodes: List[Node], free: Dict[str, int]) -> List[Node]:
        return sorted(nodes, key=lambda n: (-free[n.node_id], n.node_id))


PLACEMENT_POLICIES = {"first-fit": FirstFitPlacement, "spread": SpreadPlacement}


def make_placement_policy(policy) -> PlacementPolicy:
    """Accept a policy name or an instance (pluggable policies)."""
    if isinstance(policy, str):
        try:
            return PLACEMENT_POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown placement policy {policy!r} "
                             f"(available: {sorted(PLACEMENT_POLICIES)})")
    return policy
