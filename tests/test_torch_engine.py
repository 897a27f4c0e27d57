"""The port's serving engine and control plane against the reference:
identical per-request outputs from both engines on the same requests with
bridged weights (continuous and pump modes), the InfAdapter loop on the
port's engine, solver parity of the copied control plane, and the option
that is refused until ported (the replica fabric)."""
import time

import numpy as np
import pytest
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants

from _torch_parity import np_tree, port_config
from repro.core import solver as jsolver
from repro.core.profiles import VariantProfile as JProfile
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.core import solver as psolver
from repro_torch.core.adapter import ControllerConfig, InfAdapterController
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.profiles import VariantProfile as PProfile
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.driver import rise_fall_load, run_serving_loop
from repro_torch.serving.engine import InProcessServingEngine as PEngine

GEOMETRY = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                decode_chunk=2)


def _port_variants(jvariants):
    return {n: (port_config(c), a) for n, (c, a) in jvariants.items()}


def _requests(cls, n, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, PROMPT_LEN + 1, n)       # short prompts pad
    budgets = rng.integers(1, MAX_NEW + 3, n)       # 1 finishes at admit
    return [cls(rid=i, tokens=rng.integers(0, VOCAB, int(lens[i])),
                max_new=int(budgets[i]), arrival=time.time())
            for i in range(n)]


def _serve(engine, reqs, variants, backend_of):
    engine.apply_allocation(0.0, {n: 1 for n in variants})
    for r in reqs:
        assert engine.submit(r, backend_of(r))
    engine.drain(0.0) if engine.mode == "continuous" else engine.pump(0.0)
    return {r.rid: (r.backend, list(r.output)) for r in engine.done}


@pytest.mark.parametrize("mode", ["continuous", "pump"])
@pytest.mark.parametrize("n_variants", [1, 2])
def test_engines_give_identical_outputs(mode, n_variants):
    jv = tiny_variants(n_variants)
    names = list(jv)
    jeng = JEngine(jv, mode=mode, **GEOMETRY)
    jeng.apply_allocation(0.0, {n: 1 for n in names})
    weights = {n: params_from_jax(np_tree(jeng.backends[n].params),
                                  port_config(jv[n][0]), "cpu")
               for n in names}
    peng = PEngine(_port_variants(jv), mode=mode, device="cpu",
                   weights=weights, **GEOMETRY)

    def backend_of(r):
        return names[r.rid % len(names)]

    want = _serve(jeng, _requests(JRequest, 9, seed=n_variants), jv,
                  backend_of)
    got = _serve(peng, _requests(PRequest, 9, seed=n_variants), jv,
                 backend_of)
    assert len(want) == 9
    assert got == want
    sj = jeng.summarize(60_000, 75.0)
    sp = peng.summarize(60_000, 75.0)
    assert set(sp) == set(sj)
    assert sp["n_requests"] == 9 and sp["pending"] == 0


def test_kernel_switch_gives_identical_outputs_on_cpu():
    jv = tiny_variants(1)
    outs = []
    for on in (False, True):
        eng = PEngine(_port_variants(jv), device="cpu", use_kernels=on,
                      **GEOMETRY)
        outs.append(_serve(eng, _requests(PRequest, 5, seed=3), jv,
                           lambda r: "small"))
    assert outs[0] == outs[1]


def test_serving_loop_with_controller_on_port_engine():
    pv = _port_variants(tiny_variants(2))
    eng = PEngine(pv, device="cpu", **GEOMETRY)
    profiles = {n: PProfile(name=n, accuracy=a, rt=0.1, th_slope=20.0,
                            th_intercept=0.0, lat_base_ms=5.0,
                            lat_k_ms=50.0, max_units=4)
                for n, (_, a) in pv.items()}
    ctrl = InfAdapterController(
        profiles, MovingMaxForecaster(window=10),
        ControllerConfig(interval_s=0.5, budget=3, slo_ms=5000.0,
                         reactive=True, queue_aware=True))
    n = run_serving_loop(eng, ctrl, seconds=2.0, interval=0.5,
                         load_fn=rise_fall_load(2.0, lo=2.0, hi=8.0),
                         prompt_len=PROMPT_LEN, max_new=4, vocab=VOCAB,
                         tick_sleep=0.02, log=None)
    s = eng.summarize(5000.0, 75.0)
    assert n > 0 and s["n_requests"] == n - eng.rejected
    assert s["pending"] == 0
    assert all(len(r.output) == 4 for r in eng.done)
    assert len(ctrl.decisions) >= 2 and ctrl.audit.entries
    assert {"violation_rate", "p99_ms", "avg_cost_units",
            "accuracy_loss", "goodput"} <= set(s)


def _profile_sets(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        out.append(dict(name=f"m{i}", accuracy=float(70 + 2 * i),
                        rt=float(rng.uniform(1, 10)),
                        th_slope=float(rng.uniform(3, 15)),
                        th_intercept=float(rng.uniform(0, 10)),
                        lat_base_ms=float(rng.uniform(20, 100)),
                        lat_k_ms=float(rng.uniform(50, 600))))
    return out


@pytest.mark.parametrize("solver", ["exact", "greedy", "single",
                                    "bruteforce"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copied_solver_returns_the_reference_allocation(solver, seed):
    fields = _profile_sets(seed)
    jp = {f["name"]: JProfile(**f) for f in fields}
    pp = {f["name"]: PProfile(**f) for f in fields}
    lam = 30.0 + 10 * seed
    kw = dict(alpha=1.0, beta=0.05, gamma=0.01, loaded={"m1"})
    want = jsolver.SOLVERS[solver](jp, lam, 12, 750.0, **kw)
    got = psolver.SOLVERS[solver](pp, lam, 12, 750.0, **kw)
    assert got.units == want.units
    assert got.quotas == pytest.approx(want.quotas)
    assert got.objective == pytest.approx(want.objective)


@pytest.mark.parametrize("option", [dict(nodes=[])])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError):
        PEngine(_port_variants(tiny_variants(2)), device="cpu", **option)


def test_backpressure_and_unit_caps():
    eng = PEngine(_port_variants(tiny_variants(1)), device="cpu",
                  queue_cap=2, enforce_units=True, **GEOMETRY)
    reqs = _requests(PRequest, 4, seed=0)
    assert not eng.submit(reqs[0], "small")          # nothing loaded yet
    eng.apply_allocation(0.0, {"small": 1})
    assert [eng.submit(r, "small") for r in reqs[1:]] == [True, True, False]
    assert eng.backlog(0.0) == 2.0 and eng.rejected == 2
    assert eng.backends["small"].free_slots == [0]   # 1 unit -> 1 slot
    eng.step(0.0)
    assert eng.in_flight() + len(eng.done) >= 1
    eng.drain(0.0)
    assert eng.in_flight() == 0 and eng.backlog(0.0) == 0
    assert eng.backends["small"].readiness_s > 0.0


@pytest.mark.parametrize("spec", ["fifo", "edf", "chunked", "bogus"])
def test_fifo_scheduler_copy(spec):
    """The copied policies order as the reference's (EDF by deadline, here
    SLOs that differ per request); an unknown spec raises."""
    from repro.serving.sched import make_scheduler as jmake
    from repro_torch.serving.sched import make_scheduler as pmake
    if spec == "bogus":
        with pytest.raises(ValueError):
            pmake(spec)
        return
    reqs = _requests(PRequest, 5, seed=4)
    for i, r in enumerate(reqs):
        r.slo_ms = 1000.0 * (5 - i)
    got = [r.rid for r in pmake(spec).order(reqs, 0.0)]
    assert got == [r.rid for r in jmake(spec).order(reqs, 0.0)]
    assert pmake(spec).describe() == jmake(spec).describe()
    if spec == "fifo":
        assert pmake(spec).select_victims(reqs, reqs, 0.0, 0) == []
    else:
        assert got == [4, 3, 2, 1, 0]        # earliest deadline first
