"""The port's copy of the cluster fabric (``repro_torch.cluster``) on its
own: each module equals the reference's source once ``repro_torch`` reads
as ``repro``, so the copies cannot drift, and the placement, rolling
fabric and router cases of tests/test_cluster_fabric.py that need no
simulator run on the copies. The engine-level cases are in
tests/test_torch_cluster_engine.py."""
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from repro_torch.cluster import (FaultEvent, FaultSchedule,
                                 FirstFitPlacement,
                                 PlacementError, ReplicaFabric, ReplicaSpec,
                                 ReplicaView, RoundRobinReplicaRouter,
                                 SpreadPlacement, make_nodes, make_router,
                                 node_crash, node_recover, replica_sizes)
from repro_torch.obs import MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ no drift
@pytest.mark.parametrize("module", ["__init__", "faults", "placement",
                                    "replicas", "router"])
def test_copied_module_equals_reference(module):
    port = (ROOT / "src/repro_torch/cluster" / f"{module}.py").read_text()
    ref = (ROOT / "src/repro/cluster" / f"{module}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


# --------------------------------------------------------------- placement
def test_replica_sizes_even_split():
    assert replica_sizes(8, 2) == [2, 2, 2, 2]
    assert replica_sizes(5, 2) == [2, 2, 1]
    assert replica_sizes(3, 8) == [3]
    assert replica_sizes(0, 2) == []
    # total is always preserved
    for units in range(1, 30):
        for r in range(1, 9):
            assert sum(replica_sizes(units, r)) == units


def test_first_fit_packs_spread_spreads():
    nodes = make_nodes(3, 4)
    specs = [ReplicaSpec("m", i, 2) for i in range(3)]
    pl = FirstFitPlacement().place(nodes, specs, {})
    assert pl.feasible
    assert sorted(s.node_id for s in pl.placed) == ["node0", "node0", "node1"]
    specs = [ReplicaSpec("m", i, 2) for i in range(3)]
    pl = SpreadPlacement().place(nodes, specs, {})
    assert sorted(s.node_id for s in pl.placed) == ["node0", "node1", "node2"]


def test_placement_respects_existing_usage_and_dead_nodes():
    nodes = make_nodes(2, 4)
    nodes[0].alive = False
    pl = SpreadPlacement().place(nodes, [ReplicaSpec("m", 0, 4)],
                                 {"node1": 2})
    # node0 dead, node1 half full -> repair shrinks to the free 2 units
    assert pl.placed[0].node_id == "node1"
    assert pl.placed[0].units == 2
    assert pl.shortfall == {"m": 2}


def test_placement_strict_rejects_infeasible():
    nodes = make_nodes(1, 2)
    with pytest.raises(PlacementError):
        FirstFitPlacement().place(nodes, [ReplicaSpec("m", 0, 4)], {},
                                  strict=True)


def test_placement_repair_records_shortfall_when_full():
    nodes = make_nodes(1, 2)
    pl = FirstFitPlacement().place(nodes, [ReplicaSpec("m", 0, 2),
                                           ReplicaSpec("m", 1, 2)], {})
    assert len(pl.placed) == 1
    assert pl.shortfall == {"m": 2}


# ------------------------------------------------- the fabric on its own
def test_fabric_rolls_crashes_and_recovers():
    """The fabric without a backend: a rolling transition retires the
    surplus at the switch time, a crash kills the node's live replicas and
    lowers ``capacity_factor``, re-applying re-places on the live nodes."""
    fab = ReplicaFabric(make_nodes(2, 4), policy="spread", replica_size=1,
                        rt_fn=lambda m: 5.0)
    tr = fab.apply(0.0, {"a": 2})
    assert [r.rid for r in tr.created] == ["a#0", "a#1"]
    assert fab.variants_ready(0.0) == [] and fab.variants_ready(5.0) == ["a"]
    tr = fab.apply(10.0, {"b": 2})
    assert tr.switch_t == 15.0
    assert all(r.retire_at == 15.0 for r in tr.retired)
    assert fab.capacity_factor(12.0) == 1.0          # warming counts
    assert {r.rid for r in fab.purge(15.0)} == {"a#0", "a#1"}
    killed = fab.crash_node(20.0, "node0")
    assert [r.node_id for r in killed] == ["node0"]
    assert fab.capacity_factor(20.0) == 0.5
    fab.purge(20.0)
    fab.apply(21.0, {"b": 2})
    assert fab.capacity_factor(21.0) == 1.0
    assert {r.node_id for r in fab.replicas.values()} == {"node1"}
    fab.recover_node(22.0, "node0")
    assert fab.nodes["node0"].alive
    assert not fab.slow_replica(23.0, "a#0", 3.0)    # gone: a no-op


def test_fault_schedule_pops_in_time_order():
    sched = FaultSchedule([node_recover(9.0, "node0"),
                           node_crash(2.0, "node0")])
    assert sched.next_t() == 2.0
    assert [e.kind for e in sched.pop_due(5.0)] == ["node_crash"]
    assert len(sched) == 1 and sched.next_t() == 9.0
    with pytest.raises(ValueError):
        FaultEvent(0.0, "meteor", "node0")


# ------------------------------------------------------- two-level routing
def test_rr_router_cycles_per_variant():
    """The rr baseline must actually rotate within a variant even when
    traffic to other variants interleaves."""
    r = RoundRobinReplicaRouter()
    a = [ReplicaView("a#0", 0), ReplicaView("a#1", 0)]
    b = [ReplicaView("b#0", 0), ReplicaView("b#1", 0)]
    picks_a, picks_b = [], []
    for _ in range(4):                       # interleave a,b,a,b,...
        picks_a.append(r.pick(a))
        picks_b.append(r.pick(b))
    assert picks_a == ["a#0", "a#1", "a#0", "a#1"]
    assert picks_b == ["b#0", "b#1", "b#0", "b#1"]


def test_p2c_picks_equal_the_reference_and_are_instrumented():
    """The seeded p2c router picks what the reference's does on the same
    views, prefers the less loaded of its two samples, and with a registry
    lands every pick in it."""
    from repro.cluster import ReplicaView as JView
    from repro.cluster import make_router as jmake
    rng = np.random.default_rng(0)
    metrics = MetricsRegistry()
    port, ref = make_router("p2c", metrics=metrics), jmake("p2c")
    for _ in range(50):
        loads = rng.integers(0, 5, 4)
        got = port.pick([ReplicaView(f"m#{i}", int(x), 1)
                         for i, x in enumerate(loads)])
        want = ref.pick([JView(f"m#{i}", int(x), 1)
                         for i, x in enumerate(loads)])
        assert got == want
    assert metrics.value("router.picks") == 50
    assert port.pick([]) is None
    assert metrics.value("router.no_candidate") == 1
    assert make_router("least").pick(
        [ReplicaView("m#0", 3), ReplicaView("m#1", 1)]) == "m#1"
    with pytest.raises(ValueError):
        make_router("nope")
