"""The replica fabric on the port's engine, on the CPU: the five cases of
tests/test_cluster_engine.py (replicas per allocation, two-level routing
with variant affinity through a crash, a scale-down that drains, retry on
the survivor after a node crash, a straggler), the engine-level mirrors of
the rolling-fabric cases of tests/test_cluster_fabric.py (replicas as
backends, the shared protocols, create-then-remove, churn-free re-apply,
scale-down, stale fault events, faults without a fabric), the flight dump
an injected fault triggers (the engine-side mirror of
tests/test_obs_online.py::test_fault_injection_triggers_flight_dump), the
port engine against the reference engine under one fault schedule (crash,
recover and re-place, slow down, restore) on a fake clock with bridged fp32
weights, dense and paged, sync and async, and the launcher's fabric flags
in a subprocess."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from _torch_parity import outcome, port_variants, reference_weights
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants
from repro_torch.cluster import (make_nodes, node_crash, node_recover,
                                 replica_restore, replica_slowdown)
from repro_torch.obs import FlightRecorder, Observability
from repro_torch.obs.export import validate_trace_file
from repro_torch.serving.api import ClusterAPI, Request, ServingAPI
from repro_torch.serving.engine import InProcessServingEngine

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                decode_chunk=2, kv_page_size=4)


def _engine(n_variants=1, n_nodes=2, node_cap=2, **kw):
    """The port's engine at the tiny geometry on a fabric of ``n_nodes``
    nodes (spread placement, single-unit replicas by default)."""
    kw = {**GEOMETRY, "placement": "spread", "replica_size": 1, **kw}
    return InProcessServingEngine(port_variants(tiny_variants(n_variants)),
                                  device="cpu",
                                  nodes=make_nodes(n_nodes, node_cap), **kw)


def _reqs(n, rng):
    return [Request(rid=i, tokens=rng.integers(0, VOCAB, PROMPT_LEN),
                    max_new=MAX_NEW, arrival=time.time())
            for i in range(n)]


# ------------------------------------------ tests/test_cluster_engine.py
def test_allocation_materializes_as_engine_replicas():
    eng = _engine()
    assert isinstance(eng, ClusterAPI) and isinstance(eng, ServingAPI)
    eng.apply_allocation(0.0, {"small": 2})
    assert sorted(eng.backends) == ["small#0", "small#1"]
    # spread placement: one replica per node
    assert {r.node_id for r in eng.fabric.replicas.values()} == \
        {"node0", "node1"}
    assert eng.loaded_variants(0.0) == {"small"}
    rng = np.random.default_rng(0)
    for r in _reqs(8, rng):
        assert eng.submit(r, "small")
    eng.drain(0.0)
    assert len(eng.done) == 8
    assert {r.rid for r in eng.done} == set(range(8))     # exactly once
    served_by = {r.backend for r in eng.done}
    assert served_by == {"small#0", "small#1"}            # both replicas used
    assert eng.in_flight() == 0 and eng.backlog(0.0) == 0


def test_two_level_routing_respects_variant_choice():
    eng = _engine(n_variants=2, n_nodes=2, node_cap=2)
    eng.apply_allocation(0.0, {"small": 2, "big": 2})
    rng = np.random.default_rng(1)
    reqs = _reqs(6, rng)
    for r in reqs[:3]:
        eng.submit(r, "small")
    for r in reqs[3:]:
        eng.submit(r, "big")
    eng.step(0.0)                    # work spread across all four replicas
    # crash retry keeps variant affinity: orphans of small#x must land on
    # the surviving small replica, not spill onto big (and vice versa)
    now = time.time()
    eng.inject_fault(now, node_crash(now, "node0"))
    eng.drain(0.0)
    accs = {r.rid: r.accuracy for r in eng.done}
    assert all(accs[i] == 70.0 for i in range(3))     # small replicas only
    assert all(accs[i] == 75.0 for i in range(3, 6))  # big replicas only


def test_replica_reconfig_scale_down_drains():
    eng = _engine()
    eng.apply_allocation(0.0, {"small": 2})
    rng = np.random.default_rng(2)
    for r in _reqs(4, rng):
        eng.submit(r, "small")
    eng.step(0.0)                    # both replicas now hold work
    eng.apply_allocation(1.0, {"small": 1})
    assert len(eng.backends) == 1
    assert eng.fabric.provisioned_units() == 1
    eng.drain(1.0)
    assert len(eng.done) == 4        # drained + requeued, nothing lost


def test_node_crash_retries_on_survivor():
    eng = _engine(queue_cap=64)
    eng.apply_allocation(0.0, {"small": 2})
    rng = np.random.default_rng(3)
    for r in _reqs(10, rng):
        assert eng.submit(r, "small")
    eng.step(0.0)                    # work in flight on both replicas
    killed = eng.backends["small#0"]
    now = time.time()
    eng.inject_fault(now, node_crash(now, "node0"))
    assert sorted(eng.backends) == ["small#1"]
    assert eng.fabric.capacity_factor(now) == 0.5
    assert killed.graphs == {} and killed._pending is None   # closed
    eng.drain(0.0)
    # retry semantics: every accepted request completes exactly once
    assert {r.rid for r in eng.done} == set(range(10))
    assert len(eng.done) == 10
    assert eng.rejected == 0
    # controller-driven re-placement restores capacity on the live node set
    eng.apply_allocation(now + 1.0, {"small": 2})
    assert eng.fabric.capacity_factor(now + 1.0) == 1.0
    assert all(r.node_id == "node1"
               for r in eng.fabric.replicas.values())


def test_replica_slowdown_fault_stretches_decode():
    eng = _engine()
    eng.apply_allocation(0.0, {"small": 2})
    eng.inject_fault(0.0, replica_slowdown(0.0, "small#0", 3.0))
    assert eng.backends["small#0"].slow_factor == 3.0
    assert eng.backends["small#1"].slow_factor == 1.0
    rng = np.random.default_rng(4)
    for r in _reqs(4, rng):
        eng.submit(r, "small")
    eng.drain(0.0)
    assert len(eng.done) == 4        # still correct, just slower


# ------------------- tests/test_cluster_fabric.py, on the port's engine
def _fabric_engine(**kw):
    """The fabric geometry of test_cluster_fabric.py (4 nodes of 8 units,
    replicas of 2 units, spread) on the port's engine."""
    return _engine(n_variants=2, n_nodes=4, node_cap=8,
                   **{"replica_size": 2, **kw})


def test_fabric_materializes_allocation_as_replicas():
    eng = _fabric_engine()
    eng.apply_allocation(0.0, {"small": 8})
    reps = eng.fabric.group("small")
    assert len(reps) == 4 and all(r.units == 2 for r in reps)
    assert len({r.node_id for r in reps}) == 4          # spread
    # the engine loads synchronously: a replica is ready when it exists
    assert eng.loaded_variants(0.0) == {"small"}
    assert sorted(eng.backends) == [r.rid for r in reps]
    assert all(eng.backends[r.rid] is r.handle and r.handle.units == 2
               for r in reps)


def test_fabric_conforms_to_shared_protocols():
    eng = _fabric_engine()
    assert isinstance(eng, ClusterAPI) and isinstance(eng, ServingAPI)
    eng.mark_warm()                                      # harness no-op


def test_rolling_reconfig_drains_the_old_replicas():
    """Create-then-remove with readiness on construction: the switch is at
    once, so the old replicas drain their slots, their waiters move to the
    new replicas, and each old backend is closed; nothing is lost."""
    eng = _fabric_engine()
    eng.apply_allocation(0.0, {"small": 4})
    old = {rid: eng.backends[rid] for rid in eng.backends}
    rng = np.random.default_rng(5)
    for r in _reqs(12, rng):
        assert eng.submit(r, "small")
    eng.step(0.0)
    eng.apply_allocation(100.0, {"big": 8})
    assert all(rid.startswith("big#") for rid in eng.backends)
    assert all(b.graphs == {} and not b.active_slots for b in old.values())
    eng.drain(100.0)
    assert sorted(r.rid for r in eng.done) == list(range(12))
    assert {r.backend for r in eng.done} & set(old)        # drained there
    assert {r.backend for r in eng.done} - set(old)        # and moved on
    assert eng.cost_log == [(0.0, 4), (100.0, 8)]


def test_reapply_same_allocation_is_churn_free():
    eng = _fabric_engine()
    eng.apply_allocation(0.0, {"small": 8})
    before = dict(eng.backends)
    eng.apply_allocation(50.0, {"small": 8})
    assert eng.backends == before                        # the same objects
    assert all(r.retire_at == float("inf")
               for r in eng.fabric.replicas.values())


def test_scale_down_keeps_matching_replicas():
    eng = _fabric_engine()
    eng.apply_allocation(0.0, {"small": 8})
    eng.apply_allocation(50.0, {"small": 4})
    live = eng.fabric.group("small")
    assert sum(r.units for r in live) == 4
    assert sorted(eng.backends) == sorted(r.rid for r in live)
    assert eng.fabric.provisioned_units() == 4


def test_stale_replica_fault_events_are_noops():
    """A slowdown/restore targeting a replica that already retired must not
    crash the replay — stale fault events are skipped."""
    eng = _fabric_engine()
    eng.apply_allocation(0.0, {"small": 4})
    old = sorted(eng.fabric.replicas)[0]
    eng.apply_allocation(10.0, {"big": 4})               # small retires
    assert old not in eng.fabric.replicas and old not in eng.backends
    eng.inject_fault(30.0, replica_slowdown(30.0, old, 3.0))     # no-op
    eng.inject_fault(31.0, replica_restore(31.0, old))           # no-op
    assert all(b.slow_factor == 1.0 for b in eng.backends.values())


def test_fault_injection_requires_fabric():
    eng = InProcessServingEngine(port_variants(tiny_variants(1)),
                                 device="cpu", **GEOMETRY)
    with pytest.raises(RuntimeError, match="fabric"):
        eng.inject_fault(0.0, node_crash(0.0, "node0"))


# ------------------------------------------------- the fault's flight dump
def test_fault_injection_triggers_flight_dump(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0)
    obs = Observability(windows=True, flight=fr)
    assert obs.tracer.on                           # flight implies trace
    eng = _engine(n_nodes=1, node_cap=4, obs=obs)
    eng.apply_allocation(-100.0, {"small": 1})
    rid = next(iter(eng.fabric.replicas))
    eng.inject_fault(1.0, replica_slowdown(1.0, rid, 4.0))
    assert len(fr.dumps) == 1
    assert "fault_replica_slowdown" in fr.dumps[0]
    assert validate_trace_file(fr.dumps[0]) > 0
    eng.inject_fault(2.0, node_crash(2.0, "node0"))
    assert os.path.basename(fr.dumps[1]) == "FLIGHT_fault_node_crash.json"
    assert validate_trace_file(fr.dumps[1]) > 0
    assert eng.backends == {} and eng.capacity_factor(2.0) == 0.0


# ---------------------------------------- the port against the reference
# (tick, event): a crash of node0 with work in flight, its recovery and the
# controller's re-placement, a straggler and its restore
SCHEDULE = ((4, "crash"), (7, "recover"), (9, "slow"), (13, "restore"))
CASES = {
    "dense_sync": dict(),
    "dense_async": dict(async_tick=True),
    "paged_sync": dict(kv_cache="paged", kv_prefix_sharing=True),
    "paged_async": dict(kv_cache="paged", kv_prefix_sharing=True,
                        async_tick=True),
}


def _fault_run(side, case, n=16):
    """Serve ``n`` staggered requests (a request a tick, alternating
    variants) on a fabric of two nodes of four units, {small: 2, big: 2},
    with ``SCHEDULE``'s faults on a clock advancing 50 ms a tick. Returns
    the engine and, after each event, (event, sorted backend keys,
    capacity_factor, rejected)."""
    jv = tiny_variants(2)
    t = [1.0]
    kw = dict(GEOMETRY, clock=lambda: t[0], placement="spread",
              router="p2c", replica_size=1, queue_cap=64, **CASES[case])
    if side == "port":
        from repro_torch.cluster import make_nodes as nodes
        from repro_torch.cluster import (node_crash as crash,
                                         node_recover as recover,
                                         replica_restore as restore,
                                         replica_slowdown as slow)
        from repro_torch.serving.api import Request as Req
        eng = InProcessServingEngine(port_variants(jv), device="cpu",
                                     weights=reference_weights(jv),
                                     nodes=nodes(2, 4), **kw)
    else:
        from repro.cluster import make_nodes as nodes
        from repro.cluster import (node_crash as crash,
                                   node_recover as recover,
                                   replica_restore as restore,
                                   replica_slowdown as slow)
        from repro.serving.api import Request as Req
        from repro.serving.engine import InProcessServingEngine as JEngine
        eng = JEngine(jv, nodes=nodes(2, 4), **kw)
    alloc = {"small": 2, "big": 2}
    eng.apply_allocation(t[0], alloc)
    events = dict(SCHEDULE)
    log = [("start", sorted(eng.backends), eng.capacity_factor(t[0]), 0)]
    rng = np.random.default_rng(0)
    for i in range(200):
        if i < n:
            eng.submit(Req(rid=i, tokens=rng.integers(0, VOCAB, PROMPT_LEN),
                           max_new=int(rng.integers(2, MAX_NEW + 1)),
                           arrival=t[0]), ("small", "big")[i % 2])
        what = events.get(i)
        if what == "crash":
            eng.inject_fault(t[0], crash(t[0], "node0"))
        elif what == "recover":
            eng.inject_fault(t[0], recover(t[0], "node0"))
            eng.apply_allocation(t[0], alloc)       # the re-placement
        elif what == "slow":
            eng.inject_fault(t[0], slow(t[0], "small#1", 3.0))
        elif what == "restore":
            eng.inject_fault(t[0], restore(t[0], "small#1"))
        if what is not None:
            log.append((what, sorted(eng.backends),
                        eng.capacity_factor(t[0]), eng.rejected))
        if i >= n and not eng.backlog(t[0]) and not eng.in_flight():
            break
        eng.step(t[0])
        t[0] += 0.05
    eng.flush_pending(t[0])
    return eng, log


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_schedule_matches_the_reference_engine(case):
    ref, ref_log = _fault_run("ref", case)
    port, port_log = _fault_run("port", case)
    assert port_log == ref_log
    assert [e for e, *_ in port_log] == ["start"] + [w for _, w in SCHEDULE]
    assert outcome(port.done) == outcome(ref.done)
    assert sorted(r.rid for r in port.done) == list(range(16))   # once each
    assert port.rejected == ref.rejected == 0
    assert port.cost_log == ref.cost_log
    assert {r.rid: r.accuracy for r in port.done} == \
        {r.rid: r.accuracy for r in ref.done}
    # variant affinity through the retry
    for r in port.done:
        assert r.backend.split("#")[0] == ("small", "big")[r.rid % 2]
    if case.startswith("paged"):
        stats = port.kv_pool_stats()
        assert stats["used_pages"] == sum(
            b.pool.used_pages for b in port.backends.values())


# ------------------------------------------------------------ the launcher
def test_launcher_crashes_and_recovers_a_node(tmp_path):
    """``repro_torch.launch.serve --replicas 2 --nodes 2 --fail-node-at 2
    --flight-dir`` on the CPU smoke ladder: the crash is injected, the
    flight recorder dumps it, and the loop finishes."""
    flight = tmp_path / "flight"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--seconds", "5", "--interval", "2", "--replicas", "2", "--nodes",
         "2", "--fail-node-at", "2", "--flight-dir", str(flight)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "cluster fabric: 2 nodes x 2 units, replica_size=1 (budget 2)" \
        in out.stdout
    assert "FAULT node_crash node0" in out.stdout
    dump = flight / "FLIGHT_fault_node_crash.json"
    assert validate_trace_file(str(dump)) > 0
