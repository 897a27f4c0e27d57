"""The paper's evaluation harness in the port (``repro_torch.sim``,
``core/infaas.py``, ``core/cocktail.py``, ``data/traces.py``,
``analysis/report.py`` and the seasonal and ensemble forecasters), host
only: every copied module equals the reference's source once
``repro_torch`` reads as ``repro``; the mirrors of tests/test_traces.py,
test_sim.py, test_infaas.py, test_cocktail.py, test_report.py,
test_adapter_integration.py, the forecaster baselines of
test_forecaster.py, the ``SimCluster`` cases of test_cluster_fabric.py,
test_obs.py, test_obs_online.py and test_scheduler.py on the port's
classes; and ``run_experiment`` of InfAdapter, MS+, VPA+, INFaaS and
Cocktail in the port equal to the reference's on both paper traces, in
every summary number and every decision. The engine-driven cases are in
tests/test_torch_eval_engine.py, the launchers in
tests/test_torch_eval_launch.py."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from repro_torch.analysis.report import dryrun_table, inject, roofline_table
from repro_torch.cluster import (FaultSchedule, make_nodes, node_crash,
                                 node_recover, replica_slowdown)
from repro_torch.core.adapter import (ControllerConfig, InfAdapterController,
                                      MSPlusController, VPAPlusController)
from repro_torch.core.cocktail import (CocktailController,
                                       majority_vote_accuracy, solve_cocktail)
from repro_torch.core.forecaster import (EnsembleMaxForecaster,
                                         MovingMaxForecaster,
                                         SeasonalMaxForecaster, forecast_mae)
from repro_torch.core.infaas import INFaaSController
from repro_torch.core.profiles import VariantProfile, paper_resnet_profiles
from repro_torch.data.traces import (arrivals_from_rate, paper_bursty_trace,
                                     paper_nonbursty_trace,
                                     synthetic_twitter_trace)
from repro_torch.obs import (Alert, BurnRateRule, CollectingSink,
                             FlightRecorder, Observability, SLOMonitor)
from repro_torch.obs.export import validate_trace_file
from repro_torch.serving.api import Request
from repro_torch.sim.cluster import Backend, SimCluster
from repro_torch.sim.runner import run_experiment

ROOT = Path(__file__).resolve().parents[1]
PROFILES = paper_resnet_profiles(noise=0.0)
REF = 78.31


# ------------------------------------------------------------ no drift
@pytest.mark.parametrize("module", ["data/traces.py", "core/infaas.py",
                                    "core/cocktail.py", "sim/cluster.py",
                                    "sim/runner.py", "analysis/report.py"])
def test_copied_module_equals_reference(module):
    port = (ROOT / "src/repro_torch" / module).read_text()
    ref = (ROOT / "src/repro" / module).read_text()
    assert port.replace("repro_torch", "repro") == ref


def _from_seasonal(path):
    text = (ROOT / path).read_text()
    return text[text.index("@dataclass\nclass SeasonalMaxForecaster"):]


def test_copied_forecaster_block_equals_reference():
    """SeasonalMaxForecaster, EnsembleMaxForecaster and forecast_mae: the
    reference module's tail from the first to its last line (the rest of
    it is the JAX LSTM)."""
    port = _from_seasonal("src/repro_torch/core/forecaster.py")
    ref = _from_seasonal("src/repro/core/forecaster.py")
    assert port == ref
    assert "forecast_mae" in port and port.endswith("\n")


# ------------------------------------------------ tests/test_traces.py
def test_bursty_shape_matches_paper_fig5():
    t = paper_bursty_trace(base=40, spike=95, noise=0.0)
    assert len(t) == 1200
    assert abs(t[:550].mean() - 40) < 2          # steady
    assert t[650:780].max() > 90                 # spike
    assert t[990:1000].mean() < t[700] * 0.5     # decayed
    assert abs(t[1190] - 40) < 5                 # recovered


def test_nonbursty_gentle():
    t = paper_nonbursty_trace(noise=0.0)
    assert t.max() / t.min() < 2.5


def test_synthetic_statistics():
    t = synthetic_twitter_trace(seconds=7200, seed=3)
    assert t.min() > 0
    hour_means = t.reshape(2, 3600).mean(axis=1)
    assert (np.abs(np.diff(hour_means)) / hour_means[0] < 1.0).all()


def test_arrivals_poisson_rate():
    rate = np.full(200, 50.0, np.float32)
    arr = arrivals_from_rate(rate, seed=0)
    assert abs(len(arr) / 200 - 50.0) < 3.0
    assert (np.diff(arr) >= 0).all()


def test_traces_equal_reference():
    from repro.data import traces as ref
    for name in ("paper_bursty_trace", "paper_nonbursty_trace"):
        assert np.array_equal(globals()[name](), getattr(ref, name)())
    assert np.array_equal(synthetic_twitter_trace(seconds=3600, seed=2),
                          ref.synthetic_twitter_trace(seconds=3600, seed=2))
    rate = paper_bursty_trace()
    assert np.array_equal(arrivals_from_rate(rate, seed=4),
                          ref.arrivals_from_rate(rate, seed=4))


# ------------------------------------------------ tests/test_forecaster.py
def test_moving_max_headroom():
    fc = MovingMaxForecaster(window=10, headroom=1.2)
    assert fc.predict(np.array([10.0, 20.0, 15.0])) == 24.0


def test_ensemble_takes_max():
    a = MovingMaxForecaster(window=5, headroom=1.0)
    b = MovingMaxForecaster(window=5, headroom=2.0)
    e = EnsembleMaxForecaster(members=(a, b))
    assert e.predict(np.array([10.0])) == 20.0


def test_seasonal_and_mae_equal_reference():
    """The seasonal forecaster (its period reached and not) and
    ``forecast_mae`` give the reference's numbers on one trace."""
    from repro.core import forecaster as ref
    trace = synthetic_twitter_trace(seconds=2 * 3600, seed=5)
    got, want = [], []
    for mod, out in ((None, got), (ref, want)):
        seas = (SeasonalMaxForecaster if mod is None
                else mod.SeasonalMaxForecaster)(period=600)
        for v in trace[:900]:
            seas.observe(float(v))
        out.append(seas.predict(trace[:900]))
        fresh = (SeasonalMaxForecaster if mod is None
                 else mod.SeasonalMaxForecaster)()
        out.append(fresh.predict(trace[:900]))
        mm = (MovingMaxForecaster if mod is None else mod.MovingMaxForecaster)
        mae = forecast_mae if mod is None else mod.forecast_mae
        out.append(mae(mm(), trace, stride=300))
    assert got == want
    assert got[0] >= got[1]            # the seasonal max never lowers it


# ----------------------------------------------------- tests/test_sim.py
def test_backend_capacity_matches_profile():
    p = PROFILES["resnet50"]
    b = Backend(p, units=8, ready_at=0.0)
    # serve at the profiled rate for 10s: latencies stay bounded
    lat = []
    th = p.throughput(8)
    for i in range(int(th * 10)):
        t = i / th
        done = b.serve(t)
        lat.append(done - t)
    assert np.percentile(np.array(lat) * 1000, 99) < p.p99_ms(8) * 1.5


def test_backend_overload_queues():
    p = PROFILES["resnet50"]
    b = Backend(p, units=2, ready_at=0.0)
    th = p.throughput(2)
    lat = []
    for i in range(int(th * 3)):
        t = i / (th * 2.0)  # 2x overload
        lat.append(b.serve(t) - t)
    assert lat[-1] > lat[0]  # queue grows


def test_new_variant_waits_for_readiness():
    c = SimCluster(PROFILES)
    c.apply_allocation(0.0, {"resnet152": 4})
    assert c.backends["resnet152"].ready_at == PROFILES["resnet152"].rt
    c.dispatch(1.0, "resnet152")
    r = c.requests[-1]
    assert r.completion >= PROFILES["resnet152"].rt


def test_zero_downtime_switch():
    """Old variant keeps serving until the replacement is ready."""
    c = SimCluster(PROFILES)
    c.apply_allocation(0.0, {"resnet18": 4})
    c.backends["resnet18"].ready_at = 0.0
    c.apply_allocation(100.0, {"resnet50": 6})
    # resnet18 must retire only once resnet50 is ready
    assert c.backends["resnet18"].retire_at >= \
        100.0 + PROFILES["resnet50"].rt - 1e-9
    c.dispatch(101.0, "resnet50")      # still warming -> served by resnet18
    assert c.requests[-1].backend == "resnet18"
    t_ready = 100.0 + PROFILES["resnet50"].rt + 0.1
    c.dispatch(t_ready, "resnet50")
    assert c.requests[-1].backend == "resnet50"


def test_resize_preserves_queue_and_readiness():
    c = SimCluster(PROFILES)
    c.apply_allocation(0.0, {"resnet50": 4})
    b0 = c.backends["resnet50"]
    c.apply_allocation(50.0, {"resnet50": 8})
    b1 = c.backends["resnet50"]
    assert b1.units == 8
    assert b1.ready_at == b0.ready_at  # resize never un-warms


def test_summary_metrics():
    c = SimCluster(PROFILES)
    c.apply_allocation(-PROFILES["resnet18"].rt, {"resnet18": 8})
    rng = np.random.default_rng(0)
    t = 0.0
    for _ in range(500):
        t += rng.exponential(1 / 50.0)
        c.dispatch(t, "resnet18")
    s = c.summarize(750.0, 78.31)
    assert s["n_requests"] == 500
    assert s["violation_rate"] < 0.05
    assert abs(s["avg_accuracy"] - 69.76) < 1e-6


# --------------------------------------------------- tests/test_infaas.py
class FakeCluster:
    def apply_allocation(self, t, units):
        self.units = dict(units)

    def loaded_variants(self, t):
        return set()


def test_infaas_picks_cheapest_meeting_requirements():
    cfg = ControllerConfig(budget=20)
    c = INFaaSController(PROFILES, cfg, min_accuracy=75.0)
    elig = c._eligible()
    assert "resnet18" not in elig and "resnet34" not in elig  # below 75%
    assert elig[0] == "resnet50"  # cheapest per-RPS among eligible


def test_infaas_cost_aware_but_not_accuracy_maximizing():
    """Table 1: INFaaS optimizes cost ✓ but not accuracy ✗ — at equal budget
    InfAdapter ends with strictly better average accuracy."""
    trace = paper_nonbursty_trace(seconds=600)
    cfg = ControllerConfig(budget=20, beta=0.05, gamma=0.2)
    inf = InfAdapterController(PROFILES, MovingMaxForecaster(), cfg)
    r_inf = run_experiment("inf", inf, PROFILES, trace,
                           warm_start={"resnet18": 8}, reference_accuracy=REF)
    infa = INFaaSController(PROFILES, cfg, min_accuracy=76.0)
    r_ia = run_experiment("infaas", infa, PROFILES, trace,
                          warm_start={"resnet50": 8}, reference_accuracy=REF)
    assert r_ia.summary["violation_rate"] < 0.05       # it does meet the SLO
    assert (r_inf.summary["avg_accuracy"]
            > r_ia.summary["avg_accuracy"] + 0.3)      # but never maximizes
    assert r_ia.summary["avg_cost_units"] <= r_inf.summary["avg_cost_units"]


def test_infaas_spillover_when_primary_caps_out():
    profiles = dict(PROFILES)
    profiles["resnet50"] = dataclasses.replace(PROFILES["resnet50"],
                                               max_units=6)
    c = INFaaSController(profiles, ControllerConfig(budget=20),
                         min_accuracy=76.0)
    cl = FakeCluster()
    c.monitor.record(-1, 120)
    c.monitor.advance_to(0)
    c.step(0.0, cl)
    active = [m for m, n in cl.units.items() if n > 0]
    assert cl.units["resnet50"] == 6          # primary capped at max_units
    assert len(active) >= 2                   # spilled to next-cheapest


def test_infaas_budget_saturation_under_overload():
    c = INFaaSController(PROFILES, ControllerConfig(budget=8),
                         min_accuracy=76.0)
    cl = FakeCluster()
    c.monitor.record(-1, 500)
    c.monitor.advance_to(0)
    c.step(0.0, cl)
    assert sum(cl.units.values()) == 8        # uses the whole budget


# -------------------------------------------------- tests/test_cocktail.py
def test_majority_vote_bounds():
    # independent 3x 80% voters: 89.6%; with rho=1 -> best single
    assert abs(majority_vote_accuracy([80, 80, 80], rho=0.0) - 89.6) < 0.1
    assert majority_vote_accuracy([80, 80, 80], rho=1.0) == 80.0
    assert majority_vote_accuracy([75.0], rho=0.5) == 75.0
    mid = majority_vote_accuracy([80, 80, 80], rho=0.6)
    assert 80.0 < mid < 89.6


def test_cocktail_every_member_sized_for_full_load():
    a = solve_cocktail(PROFILES, 50.0, 30, 750.0)
    assert a.feasible
    for m, n in a.units.items():
        assert PROFILES[m].throughput(n) >= 50.0


def test_cocktail_cost_inefficiency_vs_infadapter():
    """The paper's §6 argument: ensembling sends all requests to all models,
    so at comparable accuracy Cocktail pays more resources than InfAdapter."""
    trace = paper_nonbursty_trace(seconds=600)
    cfg = ControllerConfig(budget=40, beta=0.05, gamma=0.2)
    inf = InfAdapterController(PROFILES, MovingMaxForecaster(), cfg)
    r_inf = run_experiment("inf", inf, PROFILES, trace,
                           warm_start={"resnet18": 8}, reference_accuracy=REF)
    co = CocktailController(PROFILES, MovingMaxForecaster(), cfg)
    r_co = run_experiment("cocktail", co, PROFILES, trace,
                          warm_start={"resnet18": 8}, reference_accuracy=REF)
    assert (r_co.summary["avg_cost_units"]
            > r_inf.summary["avg_cost_units"] * 1.1)
    # ensembles can beat the best single model's accuracy (negative loss ok)
    assert r_co.summary["avg_accuracy"] > 70.0


# ---------------------------------------------------- tests/test_report.py
ROW = {
    "arch": "yi-6b", "shape": "decode_32k", "mesh": "16x16", "chips": 256,
    "compute_s": 0.001, "memory_s": 0.005, "collective_s": 0.0005,
    "dominant": "memory", "usefulness": 0.4, "notes": "",
    "compile_s": 3.0, "hbm_estimate_bytes": 2e9, "fits_v5e_16gb": True,
    "sharding_fallbacks": ["x"], "skipped": False,
}


def test_tables_render():
    rows = [ROW, dict(ROW, mesh="2x16x16"),
            {"arch": "whisper-tiny", "shape": "long_500k", "skipped": True,
             "reason": "enc-dec"}]
    t1 = dryrun_table(rows)
    assert "yi-6b" in t1 and "SKIP" in t1 and "fits" in t1
    t2 = roofline_table(rows)
    assert "**memory**" in t2 and "0.005" in t2
    from repro.analysis import report as ref
    assert t1 == ref.dryrun_table(rows) and t2 == ref.roofline_table(rows)


def test_inject_idempotent(tmp_path):
    md = tmp_path / "x.md"
    md.write_text("before\n<!-- T -->\nafter")
    inject(str(md), "T", "TABLE1")
    inject(str(md), "T", "TABLE2")
    text = md.read_text()
    assert "TABLE2" in text and "TABLE1" not in text
    assert text.count("<!-- T -->") == 1


# ---------------------------------------- tests/test_adapter_integration.py
def _run(controller_cls, trace, variant=None, **cfg_kw):
    cfg = ControllerConfig(budget=20, beta=0.05, gamma=0.2, **cfg_kw)
    if controller_cls is VPAPlusController:
        c = VPAPlusController(PROFILES[variant], cfg)
        profs = {variant: PROFILES[variant]}
        warm = {variant: 8}
    else:
        c = controller_cls(PROFILES, MovingMaxForecaster(), cfg)
        profs = PROFILES
        warm = {"resnet18": 8}
    return run_experiment(controller_cls.__name__, c, profs, trace,
                          warm_start=warm, reference_accuracy=REF)


@pytest.fixture(scope="module")
def bursty_results():
    trace = paper_bursty_trace(seconds=900)
    return {
        "inf": _run(InfAdapterController, trace),
        "ms": _run(MSPlusController, trace),
        "vpa152": _run(VPAPlusController, trace, variant="resnet152"),
        "vpa18": _run(VPAPlusController, trace, variant="resnet18"),
    }


def test_infadapter_reduces_violations_vs_heavy_vpa(bursty_results):
    """Headline claim: SLO violations reduced (up to 65%) vs VPA."""
    inf = bursty_results["inf"].summary["violation_rate"]
    vpa = bursty_results["vpa152"].summary["violation_rate"]
    assert inf < vpa * 0.35


def test_infadapter_less_accuracy_loss_than_ms(bursty_results):
    assert (bursty_results["inf"].summary["accuracy_loss"]
            < bursty_results["ms"].summary["accuracy_loss"])


def test_vpa18_cheap_but_inaccurate(bursty_results):
    s = bursty_results["vpa18"].summary
    assert s["avg_cost_units"] < \
        bursty_results["inf"].summary["avg_cost_units"]
    assert s["accuracy_loss"] > 8.0


def test_nonbursty_all_meet_slo():
    trace = paper_nonbursty_trace(seconds=600)
    r = _run(InfAdapterController, trace)
    assert r.summary["violation_rate"] < 0.01


def test_reactive_extension_strictly_better():
    """Beyond-paper: reactive+queue-aware cuts violations at equal cost."""
    trace = paper_bursty_trace(seconds=900)
    faithful = _run(InfAdapterController, trace)
    reactive = _run(InfAdapterController, trace, reactive=True,
                    queue_aware=True)
    assert (reactive.summary["violation_rate"]
            <= faithful.summary["violation_rate"])
    assert (reactive.summary["avg_cost_units"]
            <= faithful.summary["avg_cost_units"] * 1.15)


# ------------------------------------- tests/test_cluster_fabric.py (sim)
def _fabric_cluster(**kw):
    kw.setdefault("nodes", make_nodes(4, 8))
    kw.setdefault("replica_size", 2)
    kw.setdefault("placement", "spread")
    return SimCluster(PROFILES, **kw)


def test_sim_backlog_counts_queued_not_in_service():
    """ClusterAPI.backlog: only queued-not-yet-in-service requests count —
    aligned with the engine's admission-queue-depth semantics."""
    prof = VariantProfile(name="v", accuracy=70.0, rt=0.0, th_slope=2.0,
                          th_intercept=0.0, lat_base_ms=500.0, lat_k_ms=0.0)
    c = SimCluster({"v": prof})
    c.apply_allocation(0.0, {"v": 1})           # th=2 rps, p=0.5s -> c=1
    assert c.backlog(0.0) == 0.0
    for _ in range(3):
        c.dispatch(0.0, "v")
    # one request in service, two queued behind it
    assert c.backlog(0.0) == pytest.approx(2.0)
    # in-service work alone is not backlog
    s = c.backends["v"].effective_service_s
    assert c.backlog(2 * s + 1e-6) == pytest.approx(0.0)


def test_p2c_keeps_replicas_balanced_under_poisson_load():
    """Power-of-two-choices: the time-averaged per-replica outstanding stays
    balanced (max/mean ratio bounded) under Poisson load at ~70% utilization
    — across seeds and replica counts (the balls-into-bins property)."""
    for seed in range(5):
        for n_rep in (2, 4, 8):
            c = SimCluster(PROFILES, nodes=make_nodes(n_rep, 2),
                           replica_size=2, router="p2c", placement="spread")
            c.apply_allocation(0.0, {"resnet50": 2 * n_rep})
            c.mark_warm()
            cap = sum(len(r.handle.server_free) / r.handle.effective_service_s
                      for r in c.fabric.replicas.values())
            rng = np.random.default_rng(seed)
            t, sums = 0.0, {}
            for _ in range(1500):
                t += rng.exponential(1.0 / (0.7 * cap))
                for r in c.fabric.replicas.values():
                    sums[r.rid] = sums.get(r.rid, 0.0) + \
                        r.handle.outstanding(t)
                c.dispatch(t, "resnet50")
            avg = np.array(list(sums.values())) / 1500.0
            assert avg.max() / max(avg.mean(), 1e-9) < 1.6, \
                f"imbalanced: seed={seed} n={n_rep} avgs={avg}"


def test_straggler_p2c_beats_load_blind_routing():
    """A slow replica (injected straggler) degrades rr/random routing far
    more than p2c — the reason two-level routing is load-aware."""
    p99 = {}
    for router in ("p2c", "random"):
        c = _fabric_cluster(router=router)
        c.apply_allocation(0.0, {"resnet50": 8})
        c.mark_warm()
        rid = sorted(c.fabric.replicas)[0]
        c.inject_fault(0.0, replica_slowdown(0.0, rid, 4.0))
        rng = np.random.default_rng(0)
        t = 0.0
        for _ in range(2500):
            t += rng.exponential(1.0 / 80.0)
            c.dispatch(t, "resnet50")
        p99[router] = c.summarize(750.0, 78.31)["p99_ms"]
    assert p99["p2c"] <= p99["random"]


def _failure_run(faults=None, seed=3):
    # first-fit packs replicas onto few nodes, so the node crash takes a
    # measurable bite out of capacity (near-capacity budget: 12 @ 60 rps)
    cluster = SimCluster(PROFILES, nodes=make_nodes(4, 8), replica_size=2,
                         placement="first-fit", router="p2c")
    cfg = ControllerConfig(budget=12, beta=0.05, gamma=0.2, reactive=True)
    ctrl = InfAdapterController(PROFILES, MovingMaxForecaster(), cfg)
    res = run_experiment("failure", ctrl, PROFILES, np.full(240, 60.0),
                         warm_start={"resnet18": 8}, reference_accuracy=REF,
                         cluster=cluster, faults=faults, seed=seed)
    return cluster, res


def _viol_rate(cluster, t0, t1, slo_ms=750.0):
    win = [r for r in cluster.requests if t0 <= r.arrival < t1]
    assert win, f"no requests in [{t0},{t1})"
    return float(np.mean([r.latency_ms > slo_ms for r in win]))


def test_node_failure_recovery_restores_slo():
    """Kill a node mid-trace: the reactive controller re-places through
    apply_allocation (capacity_factor discounts lost replicas), the SLO
    spike is real but bounded, and the post-recovery violation rate
    returns to the no-fault baseline."""
    base_cluster, _ = _failure_run(faults=None)
    faults = FaultSchedule([node_crash(80.0, "node0"),
                            node_recover(150.0, "node0")])
    cluster, _ = _failure_run(faults=faults)
    assert len(faults) == 0                      # every event injected
    # the controller re-placed: full target capacity is live again
    assert cluster.fabric.capacity_factor(239.0) == 1.0
    assert cluster.fabric.nodes["node0"].alive
    # the crash has a measurable cost...
    spike = _viol_rate(cluster, 80.0, 95.0)
    assert spike > _viol_rate(base_cluster, 80.0, 95.0)
    # ...that stays bounded (re-placement begins at the next reactive check)
    assert spike < 0.8
    assert _viol_rate(cluster, 100.0, 150.0) < 0.05     # drained well before
    # full recovery: the tail of the trace matches the no-fault baseline
    post = _viol_rate(cluster, 180.0, 240.0)
    base = _viol_rate(base_cluster, 180.0, 240.0)
    assert post <= base + 0.02


def test_all_controllers_run_on_the_fabric():
    """Acceptance: InfAdapter, MS+, VPA+, INFaaS, and Cocktail all drive the
    replica fabric unchanged through the shared ClusterAPI."""
    trace = np.full(120, 40.0)
    cfg = ControllerConfig(budget=16, beta=0.05, gamma=0.2)

    def fabric():
        return SimCluster(PROFILES, nodes=make_nodes(4, 8), replica_size=2,
                          placement="spread")

    runs = {
        "inf": InfAdapterController(PROFILES, MovingMaxForecaster(), cfg),
        "ms": MSPlusController(PROFILES, MovingMaxForecaster(), cfg),
        "vpa": VPAPlusController(PROFILES["resnet50"], cfg),
        "infaas": INFaaSController(PROFILES, cfg, min_accuracy=70.0),
        "cocktail": CocktailController(PROFILES, MovingMaxForecaster(), cfg),
    }
    for name, ctrl in runs.items():
        warm = {"resnet50": 8} if name == "vpa" else {"resnet18": 8}
        res = run_experiment(name, ctrl, PROFILES, trace, warm_start=warm,
                             reference_accuracy=REF, cluster=fabric())
        assert res.summary["n_requests"] > 0, name
        assert res.summary["violation_rate"] < 0.5, name
        assert res.summary["avg_cost_units"] > 0, name


# ---------------------------------------- tests/test_obs.py:417 (sim audit)
def test_controller_audit_end_to_end():
    profiles = paper_resnet_profiles()
    cfg = ControllerConfig(interval_s=30, budget=20, slo_ms=750.0,
                           reactive=True)
    ctrl = InfAdapterController(profiles, MovingMaxForecaster(), cfg)
    trace = np.concatenate([np.full(40, 5.0), np.full(40, 15.0)])
    run_experiment("audit", ctrl, profiles, trace, slo_ms=750.0,
                   warm_start={min(profiles): 4})
    audit = ctrl.audit
    assert len(audit.entries) >= 3
    e0 = audit.entries[0]
    assert e0.controller == "InfAdapterController"
    assert {"lam", "lam_forecast", "backlog", "capacity_factor", "solver",
            "loaded"} <= set(e0.inputs)
    assert {"units", "quotas", "objective", "predicted"} <= set(e0.outputs)
    assert e0.outputs["predicted"]["capacity_rps"] > 0
    # measured outcomes + regret attached by the runner post-drain
    measured = [e for e in audit.entries
                if e.measured and e.measured["n_requests"]]
    assert measured and all(e.regret is not None for e in measured)
    reasons = {e.reason for e in audit.entries}
    assert "interval" in reasons


# ----------------------------------- tests/test_obs_online.py (sim cases)
def _mini_controller(burn_alerts=None, reactive=False):
    cfg = ControllerConfig(interval_s=30.0, budget=8, slo_ms=750.0,
                           reactive=reactive)
    profiles = paper_resnet_profiles()
    ctrl = InfAdapterController(profiles, MovingMaxForecaster(window=10),
                                cfg, burn_alerts=burn_alerts)
    return ctrl, profiles


def test_maybe_react_resolves_on_burn_alert_without_reactive():
    sink = CollectingSink()
    ctrl, profiles = _mini_controller(burn_alerts=sink, reactive=False)
    sim = SimCluster(profiles)
    ctrl.monitor.record(0.0, 5)
    ctrl.step(0.0, sim)
    assert ctrl.maybe_react(3.0, sim) is None      # no alert pending
    sink.emit(Alert(t=3.0, slo_class="750", rule="fast5s/slow30s",
                    burn_fast=20.0, burn_slow=20.0, budget=0.05))
    d = ctrl.maybe_react(3.0, sim)
    assert d is not None and d.t == 3.0
    assert ctrl.audit.entries[-1].reason == "burn_rate"
    assert sink.pending() == 0                     # alert consumed
    # next interval step reverts to the normal reason
    ctrl.step(30.0, sim)
    assert ctrl.audit.entries[-1].reason == "interval"


def test_maybe_react_without_sink_keeps_legacy_gate():
    ctrl, profiles = _mini_controller(burn_alerts=None, reactive=False)
    sim = SimCluster(profiles)
    ctrl.monitor.record(0.0, 5)
    ctrl.step(0.0, sim)
    assert ctrl.maybe_react(3.0, sim) is None      # not reactive, no sink


def test_sim_burn_alert_resolves_before_next_interval():
    """End-to-end on the virtual clock: a replica slowdown makes requests
    miss their SLO, the monitor trips mid-interval, and the controller
    re-solves (reason burn_rate) BEFORE the next 30 s interval tick."""
    sink = CollectingSink()
    ctrl, profiles = _mini_controller(burn_alerts=sink, reactive=False)
    obs = Observability(windows=True)
    sim = SimCluster(profiles, nodes=make_nodes(2, 8), replica_size=1,
                     obs=obs)
    mon = SLOMonitor(obs.windows, budget=0.05,
                     rules=(BurnRateRule(fast_s=5.0, slow_s=15.0),),
                     sinks=(sink,), cooldown_s=60.0, min_requests=3)

    # inject the slowdown on every replica shortly after t=10
    class SlowAt(FaultSchedule):
        def __init__(self):
            super().__init__([])
            self.done = False

        def next_t(self):
            return 10.0 if not self.done else float("inf")

        def apply_due(self, t, cluster):
            if self.done or t < 10.0:
                return []
            self.done = True
            evs = []
            for rid in list(cluster.fabric.replicas):
                e = replica_slowdown(10.0, rid, 50.0)
                cluster.inject_fault(10.0, e)
                evs.append(e)
            return evs

    result = run_experiment("burn", ctrl, profiles, np.full(60, 8.0),
                            slo_ms=750.0, interval_s=30.0, seed=0,
                            cluster=sim, warm_start={list(profiles)[0]: 1},
                            faults=SlowAt(), slo_monitor=mon)
    assert result is not None
    assert len(mon.alerts) >= 1
    burn = [e for e in ctrl.audit.entries if e.reason == "burn_rate"]
    assert burn, "no burn_rate re-solve recorded"
    assert 10.0 < burn[0].t < 30.0      # reacted before the interval tick


def test_fault_injection_triggers_flight_dump(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0)
    obs = Observability(windows=True, flight=fr)
    assert obs.tracer.on                           # flight implies trace
    profiles = paper_resnet_profiles()
    sim = SimCluster(profiles, nodes=make_nodes(1, 4), replica_size=1,
                     obs=obs)
    sim.apply_allocation(-100.0, {list(profiles)[0]: 1})
    rid = next(iter(sim.fabric.replicas))
    sim.inject_fault(1.0, replica_slowdown(1.0, rid, 4.0))
    assert len(fr.dumps) == 1
    assert "fault_replica_slowdown" in fr.dumps[0]
    assert validate_trace_file(fr.dumps[0]) > 0


# ------------------------------------ tests/test_scheduler.py (DES mirror)
def test_sim_edf_assigns_deadline_first():
    profiles = {"resnet18": paper_resnet_profiles()["resnet18"]}
    waits = {}
    for sched in ("fifo", "edf"):
        c = SimCluster(profiles, scheduler=sched)
        c.apply_allocation(0.0, {"resnet18": 1})
        c.mark_warm(t=0.0)
        for i in range(30):
            c.dispatch(0.001 * i, "resnet18", slo_ms=60_000.0)
        c.dispatch(0.05, "resnet18", slo_ms=100.0)     # tight straggler
        c.drain(1e9)
        s = c.summarize(60_000.0, 72.0, window_s=0)
        assert s["n_requests"] == 31
        tight = [r for r in c.requests if r.slo_ms == 100.0][0]
        waits[sched] = tight.latency_ms
    assert waits["edf"] < waits["fifo"] * 0.5          # jumped the queue


def test_sim_edf_no_lookahead_and_conservation():
    """EDF assignment may not peek at requests that had not arrived by the
    server-free instant, and every submission is served exactly once."""
    profiles = {"resnet18": paper_resnet_profiles()["resnet18"]}
    c = SimCluster(profiles, scheduler="edf")
    c.apply_allocation(0.0, {"resnet18": 1})
    c.mark_warm(t=0.0)
    c.dispatch(0.0, "resnet18", slo_ms=60_000.0)       # served immediately
    served_first = c.requests[-1] if c.requests else None
    c.dispatch(100.0, "resnet18", slo_ms=1.0)          # arrives much later
    c.drain(1e9)
    assert len(c.requests) == 2
    # the first request was not delayed waiting for the tighter future one
    first = min(c.requests, key=lambda r: r.arrival)
    assert first.service_start < 1.0
    assert served_first is None or served_first.arrival == 0.0


def test_sim_edf_serves_expired_deadlines_last():
    """DES parity with the engine's expired-last EDF: a request whose
    deadline already passed must not absorb a server ahead of
    still-feasible waiters (one violation must not become two)."""
    profiles = {"resnet18": paper_resnet_profiles()["resnet18"]}
    c = SimCluster(profiles, scheduler="edf")
    c.apply_allocation(0.0, {"resnet18": 1})
    c.mark_warm(t=0.0)
    # saturate so a queue forms, then add one long-expired request and a
    # batch of feasible ones — all pending at the same instant
    for _ in range(40):
        c.dispatch(0.0, "resnet18", slo_ms=60_000.0)
    c.dispatch(0.01, "resnet18", slo_ms=0.001)     # deadline already gone
    for _ in range(10):
        c.dispatch(0.02, "resnet18", slo_ms=60_000.0)
    c.drain(1e9)
    expired = [r for r in c.requests if r.slo_ms == 0.001][0]
    feasible_after = [r for r in c.requests
                      if r.slo_ms == 60_000.0 and r.arrival == 0.02]
    assert all(r.service_start <= expired.service_start
               for r in feasible_after)


def test_sim_experiment_end_to_end_with_edf():
    """run_experiment drives a scheduler-mirrored cluster unchanged and the
    summary carries goodput."""
    profiles = paper_resnet_profiles()
    trace = np.full(60, 30.0, np.float32)
    cfg = ControllerConfig(budget=20, beta=0.05, gamma=0.2)
    ctrl = InfAdapterController(profiles, MovingMaxForecaster(), cfg)
    res = run_experiment("edf-sim", ctrl, profiles, trace,
                         cluster=SimCluster(profiles, scheduler="edf"),
                         warm_start={"resnet18": 8})
    assert res.summary["n_requests"] > 1000
    assert 0.0 <= res.summary["goodput"] <= 1.0


# ------------------------------------ the port's harness = the reference's
def _experiment(pkg, kind, trace_name):
    """One controller's ``run_experiment`` in one package on a paper trace
    (the paper's settings: budget 20, beta 0.05, gamma 0.2, 750 ms)."""
    if pkg == "ref":
        from repro.core import adapter, cocktail, forecaster, infaas
        from repro.core.profiles import paper_resnet_profiles as profiles_of
        from repro.data import traces
        from repro.sim.runner import run_experiment as run
    else:
        from repro_torch.core import (adapter, cocktail, forecaster,
                                      infaas)
        from repro_torch.core.profiles import \
            paper_resnet_profiles as profiles_of
        from repro_torch.data import traces
        from repro_torch.sim.runner import run_experiment as run
    profiles = profiles_of()
    cfg = adapter.ControllerConfig(budget=20, beta=0.05, gamma=0.2)
    fc = forecaster.MovingMaxForecaster()
    warm = {"resnet18": 8}
    if kind == "infadapter":
        ctrl = adapter.InfAdapterController(profiles, fc, cfg)
    elif kind == "ms+":
        ctrl = adapter.MSPlusController(profiles, fc, cfg)
    elif kind == "vpa+":
        ctrl = adapter.VPAPlusController(profiles["resnet152"], cfg)
        profiles, warm = {"resnet152": profiles["resnet152"]}, \
            {"resnet152": 8}
    elif kind == "infaas":
        ctrl = infaas.INFaaSController(profiles, cfg, min_accuracy=76.0)
        warm = {"resnet50": 8}
    else:
        ctrl = cocktail.CocktailController(profiles, fc, cfg)
    trace = getattr(traces, trace_name)()
    return run(kind, ctrl, profiles, trace, warm_start=warm,
               reference_accuracy=REF)


def _decisions(res):
    return [(d.t, d.predicted_load, d.allocation.units, d.allocation.quotas,
             d.allocation.objective, d.allocation.feasible)
            for d in res.decisions]


@pytest.mark.parametrize("trace_name", ["paper_bursty_trace",
                                        "paper_nonbursty_trace"])
@pytest.mark.parametrize("kind", ["infadapter", "ms+", "vpa+", "infaas",
                                  "cocktail"])
def test_run_experiment_equals_reference(kind, trace_name):
    got = _experiment("port", kind, trace_name)
    want = _experiment("ref", kind, trace_name)
    for key in ("violation_rate", "p99_ms", "accuracy_loss",
                "avg_cost_units", "n_requests", "goodput"):
        assert got.summary[key] == want.summary[key], key
    assert got.summary == want.summary
    assert len(got.decisions) == len(want.decisions) > 30
    assert _decisions(got) == _decisions(want)
