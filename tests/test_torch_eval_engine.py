"""The paper's five controllers on the port's engine, on the CPU: the
engine half of tests/test_continuous_batching.py's shared-protocol case,
InfAdapter, MS+, VPA+, INFaaS and Cocktail driving the port's
``InProcessServingEngine`` through ``run_serving_loop`` against the same
controllers driving the reference's engine (the launcher's smoke ladder
in fp32 on bridged weights, both loops on one fake clock whose ``sleep``
advances it): decisions, backend keys, rejections, the cost log and every
finished request's tokens equal; Cocktail's requests land on one ensemble
member each (the reference's loop has no fan-out); and ``run_experiment``
refuses a fan-out controller on an engine in both packages."""
import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from _torch_parity import outcome, port_variants, reference_weights
from repro.core import adapter as j_adapter
from repro.core import cocktail as j_cocktail
from repro.core import forecaster as j_forecaster
from repro.core import infaas as j_infaas
from repro.core.profiles import VariantProfile as JProfile
from repro.launch.serve import build_ladder as j_ladder
from repro.serving import driver as j_driver
from repro.serving.engine import InProcessServingEngine as JEngine
from repro.sim import runner as j_runner
from repro_torch.core import adapter as p_adapter
from repro_torch.core import cocktail as p_cocktail
from repro_torch.core import forecaster as p_forecaster
from repro_torch.core import infaas as p_infaas
from repro_torch.core.profiles import VariantProfile as PProfile
from repro_torch.core.profiles import paper_resnet_profiles
from repro_torch.serving import driver as p_driver
from repro_torch.serving.api import ClusterAPI, ServingAPI
from repro_torch.serving.engine import InProcessServingEngine as PEngine
from repro_torch.sim import runner as p_runner
from repro_torch.sim.cluster import SimCluster

# the reference launcher's smoke ladder (d_model 128, 2/4/6 layers, fp32)
# at its smoke geometry; synthetic profiles shaped like a measured ladder
JVARIANTS = j_ladder("tinyllama-1.1b")
GEOMETRY = dict(max_batch=4, prompt_len=16, max_new=8, decode_chunk=4,
                queue_cap=6)
PROFILE = {                # name -> (th_slope, lat_base_ms, lat_k_ms)
    "tinyllama-1.1b-L2": (9.0, 40.0, 160.0),
    "tinyllama-1.1b-L4": (6.0, 60.0, 240.0),
    "tinyllama-1.1b-L6": (4.0, 90.0, 330.0),
}
SLO_MS = 1000.0
BUDGET = 12                # room for Cocktail's three-member ensemble
SECONDS, INTERVAL = 6.0, 2.0
LOAD = (6.0, 45.0)         # rise_fall_load's lo, hi req/s
CONTROLLERS = ("infadapter", "ms+", "vpa+", "infaas", "cocktail")


class FakeTime:
    """A clock for ``run_serving_loop``: ``sleep`` advances it."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _profiles(cls):
    return {n: cls(name=n, accuracy=JVARIANTS[n][1], rt=0.5, th_slope=th,
                   th_intercept=0.0, lat_base_ms=lb, lat_k_ms=lk,
                   max_units=4)
            for n, (th, lb, lk) in PROFILE.items()}


def _controller(kind, adapter, forecaster, infaas, cocktail, profiles):
    cfg = adapter.ControllerConfig(interval_s=INTERVAL, budget=BUDGET,
                                   slo_ms=SLO_MS, beta=0.05, gamma=0.05,
                                   reactive=True, queue_aware=True)
    fc = forecaster.MovingMaxForecaster(window=10)
    if kind == "infadapter":
        return adapter.InfAdapterController(profiles, fc, cfg)
    if kind == "ms+":
        return adapter.MSPlusController(profiles, fc, cfg)
    if kind == "vpa+":
        return adapter.VPAPlusController(profiles["tinyllama-1.1b-L6"], cfg)
    if kind == "infaas":
        return infaas.INFaaSController(profiles, cfg, min_accuracy=70.0)
    return cocktail.CocktailController(profiles, fc, cfg)


def _drive(monkeypatch, side, kind):
    """One controller driving one package's engine for SECONDS of fake
    time. Returns (engine, controller)."""
    clock = FakeTime()
    if side == "ref":
        driver, mods, cls = j_driver, (j_adapter, j_forecaster, j_infaas,
                                       j_cocktail), JProfile
        eng = JEngine(JVARIANTS, clock=clock.time, **GEOMETRY)
    else:
        driver, mods, cls = p_driver, (p_adapter, p_forecaster, p_infaas,
                                       p_cocktail), PProfile
        eng = PEngine(port_variants(JVARIANTS), device="cpu",
                      weights=reference_weights(JVARIANTS), clock=clock.time,
                      **GEOMETRY)
    ctrl = _controller(kind, *mods, _profiles(cls))
    monkeypatch.setattr(driver, "time", clock)
    eng.submitted = driver.run_serving_loop(
        eng, ctrl, seconds=SECONDS, interval=INTERVAL,
        load_fn=driver.rise_fall_load(SECONDS, *LOAD), seed=3,
        prompt_len=GEOMETRY["prompt_len"], max_new=GEOMETRY["max_new"],
        vocab=JVARIANTS["tinyllama-1.1b-L2"][0].vocab_size, slo_ms=SLO_MS,
        log=None)
    monkeypatch.undo()
    return eng, ctrl


def _decisions(ctrl):
    return [(d.t, d.predicted_load,
             {m: n for m, n in d.allocation.units.items() if n},
             {m: q for m, q in d.allocation.quotas.items() if q > 0})
            for d in ctrl.decisions]


@pytest.fixture(scope="module")
def served():
    """Every controller on both engines, once for the module."""
    mp = pytest.MonkeyPatch()
    try:
        return {(side, kind): _drive(mp, side, kind)
                for kind in CONTROLLERS for side in ("ref", "port")}
    finally:
        mp.undo()


@pytest.mark.parametrize("kind", CONTROLLERS)
def test_controller_on_port_engine_equals_reference_engine(served, kind):
    (jeng, jctrl), (peng, pctrl) = served["ref", kind], served["port", kind]
    assert len(pctrl.decisions) >= SECONDS / INTERVAL
    assert _decisions(pctrl) == _decisions(jctrl)
    assert peng.rejected == jeng.rejected
    assert peng.cost_log == jeng.cost_log
    got, want = outcome(peng.done), outcome(jeng.done)
    assert len(got) > 20
    assert got == want
    # every submitted request finished or was counted as rejected
    assert len(got) + peng.rejected == peng.submitted
    s = peng.summarize(SLO_MS, 78.0)
    assert s["pending"] == 0 and s["n_requests"] == len(got)


def test_cocktail_sends_each_request_to_one_ensemble_member(served):
    for side in ("ref", "port"):
        eng, ctrl = served[side, "cocktail"]
        ensembles = [d.allocation.active_variants() for d in ctrl.decisions]
        assert max(map(len, ensembles)) == 3
        backends = [r.backend for r in eng.done]
        assert set(backends) <= set().union(*ensembles)
        assert len(set(backends)) > 1         # round robin over members
        # one member a request: each rid completes once, and every
        # submission completed or was rejected (no copies)
        assert len({r.rid for r in eng.done}) == len(eng.done)
        assert len(eng.done) + eng.rejected == eng.submitted


@pytest.mark.parametrize("side", ["ref", "port"])
def test_run_experiment_refuses_fanout_on_an_engine(side):
    if side == "ref":
        runner, cocktail, adapter, forecaster = (j_runner, j_cocktail,
                                                 j_adapter, j_forecaster)
        eng = JEngine(JVARIANTS, **GEOMETRY)
        profiles = _profiles(JProfile)
    else:
        runner, cocktail, adapter, forecaster = (p_runner, p_cocktail,
                                                 p_adapter, p_forecaster)
        eng = PEngine(port_variants(JVARIANTS), device="cpu", **GEOMETRY)
        profiles = _profiles(PProfile)
    ctrl = cocktail.CocktailController(
        profiles, forecaster.MovingMaxForecaster(),
        adapter.ControllerConfig(budget=BUDGET, slo_ms=SLO_MS))
    with pytest.raises(TypeError, match="fanout"):
        runner.run_experiment("cocktail", ctrl, profiles,
                              np.full(3, 2.0), slo_ms=SLO_MS, cluster=eng)


# ---------------------------------- tests/test_continuous_batching.py:134
def test_engine_and_sim_implement_shared_protocols():
    eng = PEngine(port_variants(JVARIANTS), device="cpu", **GEOMETRY)
    eng.apply_allocation(0.0, {"tinyllama-1.1b-L2": 1})
    sim = SimCluster(paper_resnet_profiles())
    for obj in (eng, sim):
        assert isinstance(obj, ClusterAPI)
        assert isinstance(obj, ServingAPI)


# ---------------------------------------------------- tests/test_obs.py:367
def test_sim_and_engine_emit_same_metric_names():
    from repro_torch.obs import trace as ev
    from repro_torch.serving.api import Request
    profiles = paper_resnet_profiles()
    sim = SimCluster(profiles, trace=True)
    name = next(iter(profiles))
    sim.apply_allocation(-100.0, {name: 2})
    for i in range(40):
        sim.submit(Request(rid=i, tokens=np.zeros(0, np.int64), max_new=1,
                           arrival=float(i) * 0.05, slo_ms=750.0), name)
    sim.drain(2.0)
    clk = [0.0]
    eng = PEngine(port_variants(JVARIANTS), device="cpu",
                  clock=lambda: clk[0], trace=True, **GEOMETRY)
    eng.apply_allocation(0.0, {"tinyllama-1.1b-L2": 1})
    rng = np.random.default_rng(1)
    for i in range(6):
        eng.submit(Request(rid=i, tokens=rng.integers(0, 64, 16), max_new=4,
                           arrival=clk[0], slo_ms=1e6), None)
        eng.step(clk[0])
        clk[0] += 0.01
    eng.drain(clk[0])
    assert len(eng.done) == 6
    core = {"requests.submitted", "requests.completed",
            "requests.goodput_ok", "request.latency_ms",
            "request.queue_wait_ms", "request.service_ms"}
    assert core <= set(sim.metrics.names())
    assert core <= set(eng.metrics.names())
    # sim requests got span streams too
    spanned = [rid for rid, evs in sim.tracer.events.items() if evs]
    assert len(spanned) == 40
    for evs in sim.tracer.events.values():
        assert [e.t for e in evs] == sorted(e.t for e in evs)
        assert evs[-1].name in (ev.COMPLETE, ev.DROP)
