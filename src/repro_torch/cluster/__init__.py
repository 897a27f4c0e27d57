"""Multi-replica cluster fabric: placement, two-level routing, failures.

The horizontal dimension the paper's InfAdapter leaves implicit: an
allocation of n units materializes as a **placement of replicas across
nodes** (``placement``/``replicas``), requests reach a replica via
**two-level routing** — smooth WRR over variants by solver quota, then a
power-of-two-choices least-outstanding pick over that variant's replicas
(``router``) — and **failure scenarios** (node crashes, stragglers,
recovery) are injected through one schedule (``faults``) so controllers'
re-placement behaviour is measurable end-to-end.

Backend-agnostic by construction: ``repro.sim.cluster.SimCluster`` and
``repro.serving.engine.InProcessServingEngine`` both mount the same
``ReplicaFabric`` (pass ``nodes=`` to either) and stay conformant to the
shared ``ClusterAPI``/``ServingAPI`` (``repro.serving.api``), so every
controller runs on the fabric unchanged. This package is numpy-only — the
simulator path never imports JAX.
"""
from repro_torch.cluster.faults import (FaultEvent, FaultSchedule, node_crash,
                                  node_recover, replica_restore,
                                  replica_slowdown)
from repro_torch.cluster.placement import (PLACEMENT_POLICIES, FirstFitPlacement,
                                     Node, Placement, PlacementError,
                                     PlacementPolicy, ReplicaSpec,
                                     SpreadPlacement, make_nodes,
                                     make_placement_policy, replica_sizes)
from repro_torch.cluster.replicas import Replica, ReplicaFabric, Transition
from repro_torch.cluster.router import (ROUTERS, LeastOutstandingRouter,
                                  PowerOfTwoChoicesRouter,
                                  RandomReplicaRouter, ReplicaView,
                                  RoundRobinReplicaRouter, RoutingAPI,
                                  make_router)

__all__ = [
    "FaultEvent", "FaultSchedule", "node_crash", "node_recover",
    "replica_restore", "replica_slowdown",
    "PLACEMENT_POLICIES", "FirstFitPlacement", "Node", "Placement",
    "PlacementError", "PlacementPolicy", "ReplicaSpec", "SpreadPlacement",
    "make_nodes", "make_placement_policy", "replica_sizes",
    "Replica", "ReplicaFabric", "Transition",
    "ROUTERS", "LeastOutstandingRouter", "PowerOfTwoChoicesRouter",
    "RandomReplicaRouter", "ReplicaView", "RoundRobinReplicaRouter",
    "RoutingAPI", "make_router",
]
