"""The port's profiler on the port's engine, on the CPU: the mirror of
tests/test_profiling_integration.py (measured sweep, queue/service split,
store persistence, roofline cross-calibration, drift flagged on an
injected slowdown and the recalibrated profile shifting the solver's
allocation), the same work as the reference's profiler (the reference's
weights, the same rids and prompts at each point, equal greedy tokens),
throwaway backends closed and live ones left serving with their slot cap
restored, a paged engine profiled on a paged throwaway, and the
``repro_torch.launch.profile_and_serve`` launcher in a subprocess.

The drift mirror holds the detector against a profile measured on the same
backend in the same test, with a stall of 10x the measured mean service
time, so no wall-clock band separates two backends built apart."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from _torch_parity import port_variants, reference_weights
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.adapter import ControllerConfig, InfAdapterController
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.solver import solve_exact
from repro_torch.launch.profile_and_serve import stall_decode_chunks
from repro_torch.profiling.calibrate import (calibrated_roofline_profile,
                                             roofline_scale_factor)
from repro_torch.profiling.drift import DriftDetector, OnlineRecalibrator
from repro_torch.profiling.measure import EngineProfiler, fit_latency
from repro_torch.profiling.store import ProfileStore
from repro_torch.serving.api import Request
from repro_torch.serving.engine import (InProcessServingEngine,
                                        PagedVariantBackend)

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 8
PROMPT = 8


def _variants():
    base = smoke_variant(get_config("tinyllama-1.1b")).replace(
        d_model=64, d_ff=128, vocab_size=128)
    return {"small": (base.replace(num_layers=2, name="small"), 70.0)}


def _engine(**kw):
    return InProcessServingEngine(_variants(), max_batch=4, prompt_len=PROMPT,
                                  max_new=MAX_NEW, decode_chunk=4,
                                  enforce_units=True, device="cpu", **kw)


def _submit(eng, n, rng, backend="small"):
    for i in range(n):
        eng.submit(Request(rid=i, tokens=rng.integers(0, 128, PROMPT),
                           max_new=MAX_NEW, arrival=time.time()), backend)
    eng.drain(0.0)


@pytest.fixture(scope="module")
def profiled():
    """One measured sweep shared by the tests in this module."""
    eng = _engine()
    profiler = EngineProfiler(eng, points=(1, 2, 4), requests_per_point=10,
                              warmup=3, max_units=8)
    return eng, profiler, profiler.profile_variant("small")


# -------------------------------- tests/test_profiling_integration.py
def test_measured_profile_shape(profiled):
    _, _, m = profiled
    assert [p.units for p in m.points] == [1, 2, 4]
    assert m.readiness_s > 0.0                    # measured load time
    assert m.profile.rt == m.readiness_s
    # continuous batching amortizes prefill+chunk cost: capacity grows with
    # the allocation's concurrency
    assert m.points[-1].throughput_rps > m.points[0].throughput_rps
    assert 0.0 <= m.confidence <= 1.0
    assert 0.0 <= m.th_fit.r_squared <= 1.0
    for p in m.points:
        assert p.n_requests >= 10     # whole completion batches are counted
        assert p.mean_service_ms > 0.0
        # the profiler admits directly into free slots: queue wait is
        # negligible next to service
        assert p.mean_queue_ms < p.mean_service_ms


def test_queue_service_split_in_serving(profiled):
    """Live serving stamps the split; components add up to end-to-end."""
    eng, _, _ = profiled
    eng.apply_allocation(0.0, {"small": 2})
    _submit(eng, 12, np.random.default_rng(0))
    assert len(eng.done) >= 12
    for r in eng.done:
        assert r.service_start > 0.0
        assert abs(r.queue_wait_ms + r.service_ms - r.latency_ms) < 1e-2
    s = eng.summarize(slo_ms=60_000, best_accuracy=70.0)
    assert s["mean_service_ms"] > 0.0
    assert s["mean_queue_ms"] >= 0.0
    assert s["p99_service_ms"] <= s["p99_ms"] + 1e-9


def test_store_roundtrip_measured(profiled, tmp_path):
    _, _, m = profiled
    store = ProfileStore(str(tmp_path / "m.json"))
    store.register(m.profile, "measured", fit=m.th_fit,
                   meta={"confidence": m.confidence})
    loaded = ProfileStore.load(store.save())
    assert loaded.get("small") == m.profile
    assert loaded.entry("small").provenance == "measured"


def test_roofline_cross_calibration(profiled):
    """The calibrated roofline reproduces a measured variant's slope by
    construction (single-reference calibration) and scales latency
    inversely."""
    _, _, m = profiled
    cfgs = {n: c for n, (c, _) in _variants().items()}
    scale = roofline_scale_factor({"small": m}, cfgs)
    assert scale > 0.0
    cal = calibrated_roofline_profile(cfgs["small"], 70.0, scale=scale)
    raw = calibrated_roofline_profile(cfgs["small"], 70.0, scale=1.0)
    assert np.isclose(cal.th_slope, m.th_fit.slope, rtol=1e-6)
    assert np.isclose(cal.lat_k_ms * scale, raw.lat_k_ms, rtol=1e-6)


def test_drift_flagged_and_recalibration_shifts_allocation(tmp_path):
    """Healthy engine within band of a profile measured on the same
    backend; the slowed engine flagged; the targeted re-profile patches
    store + controller and the Eq. 1 solver provisions more units for the
    same load."""
    eng = _engine()
    eng.apply_allocation(0.0, {"small": 2})
    b = eng.backends["small"]
    m = EngineProfiler(eng, points=(1, 2), requests_per_point=8, warmup=2,
                       max_units=8).profile_variant("small")
    assert b.slot_cap == 2 and eng.backends["small"] is b
    store = ProfileStore(str(tmp_path / "d.json"))
    store.register(m.profile, "measured", fit=m.th_fit, meta=m.store_meta())

    # tolerance 1.0 -> band [0.5, 2.0]
    detector = DriftDetector(store, tolerance=1.0, min_requests=8)
    rng = np.random.default_rng(1)
    _submit(eng, 12, rng)
    detector.observe_engine(eng)
    healthy = detector.check("small", units=2)
    assert not healthy.drifted, healthy.reason
    assert healthy.n_obs >= 8

    # a stall of 10x the measured mean service time ahead of every chunk
    stall_s = 10 * max(p.mean_service_ms for p in m.points) / 1e3
    stall_decode_chunks(b, stall_s)
    _submit(eng, 12, rng)
    detector.observe_engine(eng)
    drifted = detector.check("small", units=2)
    assert drifted.drifted
    assert drifted.service_ratio > 2.0

    profiler = EngineProfiler(eng, requests_per_point=8, warmup=2,
                              max_units=8)
    ctrl = InfAdapterController(store.profiles(),
                                MovingMaxForecaster(window=5),
                                ControllerConfig(budget=8, slo_ms=100_000.0))
    recal = OnlineRecalibrator(profiler, store, controller=ctrl,
                               detector=detector, points=(1, 2),
                               requests_per_point=6)
    m2 = recal.recalibrate("small")
    assert m2.profile.throughput(1) < 0.8 * m.profile.throughput(1)
    assert ctrl.profiles["small"] == m2.profile          # live patch
    assert store.entry("small").meta["recalibrated"] is True
    assert detector.check("small", 2).reason.startswith("insufficient")
    assert b.slot_cap == 2 and eng.backends["small"] is b

    lam = 0.8 * m.profile.throughput(1)
    before = solve_exact({"small": m.profile}, lam, 8, 100_000.0)
    after = solve_exact({"small": m2.profile}, lam, 8, 100_000.0)
    assert after.total_units() > before.total_units()


def test_fit_latency_degenerate_and_hyperbolic():
    base, k, r2 = fit_latency([(1, 130.0), (2, 80.0), (4, 55.0)])
    # exact hyperbola 30 + 100/n
    assert abs(base - 30.0) < 1e-6 and abs(k - 100.0) < 1e-6
    assert r2 > 0.999
    # flat data: constant model, perfect fit, never a negative k
    base, k, r2 = fit_latency([(1, 50.0), (2, 50.0), (4, 50.0)])
    assert base == 50.0 and k == 0.0 and r2 == 1.0
    # rising-in-n data degrades to the constant model (k clamped at 0)
    base, k, _ = fit_latency([(1, 40.0), (2, 50.0), (4, 60.0)])
    assert k == 0.0 and base == 50.0


# ------------------------------------------- the same work as the reference
def _recording(engine, log):
    """Wrap the engine's backend factory so every backend it builds logs
    the (rid, tokens) of each request it finishes, in order."""
    make = engine._make_backend

    def make_logged(name):
        b = make(name)
        for meth in ("admit", "decode_step_batch"):
            orig = getattr(b, meth)

            def logged(*a, _orig=orig, **kw):
                done = _orig(*a, **kw)
                log.extend((r.rid, [int(t) for t in r.output]) for r in done)
                return done
            setattr(b, meth, logged)
        return b
    engine._make_backend = make_logged


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_profiler_does_the_reference_profilers_work(kv_cache):
    """Both profilers on the reference's fp32 weights: at every point the
    same rids get the same prompts, so every finished request's greedy
    tokens are equal, and the points count the same requests (wall-clock
    rates are not compared)."""
    from conftest import tiny_variants
    from repro.profiling.measure import EngineProfiler as RefProfiler
    from repro.serving.engine import InProcessServingEngine as RefEngine
    jvariants = tiny_variants(1)
    geo = dict(max_batch=2, prompt_len=PROMPT, max_new=6, decode_chunk=2,
               kv_cache=kv_cache, kv_page_size=4)
    ref_eng = RefEngine(jvariants, **geo)
    eng = InProcessServingEngine(port_variants(jvariants), device="cpu",
                                 weights=reference_weights(jvariants), **geo)
    logs = {}
    ms = {}
    for tag, e, P in (("ref", ref_eng, RefProfiler),
                      ("port", eng, EngineProfiler)):
        logs[tag] = []
        _recording(e, logs[tag])
        ms[tag] = P(e, points=(1, 2), requests_per_point=4, warmup=2,
                    seed=3).profile_variant("small")
    assert len(logs["port"]) >= 12
    assert logs["port"] == logs["ref"]
    assert [(p.units, p.n_requests) for p in ms["port"].points] == \
        [(p.units, p.n_requests) for p in ms["ref"].points]


# ------------------------------------------------ throwaways and live ones
def _spy_close(monkeypatch, cls):
    closed = []
    orig = cls.close

    def close(self):
        closed.append(self)
        orig(self)
    monkeypatch.setattr(cls, "close", close)
    return closed


def test_throwaway_backend_closed_live_backend_kept(monkeypatch):
    from repro_torch.serving.engine import VariantBackend
    closed = _spy_close(monkeypatch, VariantBackend)
    eng = _engine()
    built = []
    make = eng._make_backend
    eng._make_backend = lambda name: built.append(make(name)) or built[-1]
    profiler = EngineProfiler(eng, points=(1, 2), requests_per_point=4,
                              warmup=2)
    m = profiler.profile_variant("small")
    assert [p.units for p in m.points] == [1, 2]
    (tb,) = built
    assert closed == [tb] and not tb._steps and not tb.graphs
    assert "small" not in eng.backends

    # a live backend is profiled in place: not closed, its cap restored,
    # still serving afterwards
    eng.apply_allocation(0.0, {"small": 3})
    b = eng.backends["small"]
    assert b.slot_cap == 3
    steps = dict(b._steps)
    profiler.profile_variant("small")
    assert closed == [tb] and len(built) == 2     # the load, no throwaway
    assert b.slot_cap == 3 and b._steps == steps
    assert eng.backends["small"] is b
    _submit(eng, 6, np.random.default_rng(2))
    assert len(eng.done) == 6
    assert all(len(r.output) == MAX_NEW for r in eng.done)


def test_paged_engine_profiles_a_paged_throwaway(monkeypatch):
    """A paged engine's throwaway is paged (the engine's own factory), the
    sweep skips points above max_batch, and the throwaway is closed."""
    closed = _spy_close(monkeypatch, PagedVariantBackend)
    eng = _engine(kv_cache="paged", kv_page_size=4)
    m = EngineProfiler(eng, requests_per_point=4,
                       warmup=2).profile_variant("small")
    assert [p.units for p in m.points] == [1, 2, 4]    # 8 and 16 skipped
    assert len(closed) == 1 and isinstance(closed[0], PagedVariantBackend)
    assert closed[0].pool.used_pages == 0


# ------------------------------------------------------------ the launcher
def test_profile_and_serve_launcher_runs_on_the_cpu(tmp_path):
    store = tmp_path / "profiles.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile_and_serve",
         "--device", "cpu", "--seconds", "2", "--interval", "1",
         "--store", str(store)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = ProfileStore.load(str(store))
    assert loaded.names() == ["tinyllama-1.1b-L2", "tinyllama-1.1b-L4",
                              "tinyllama-1.1b-L6", "tinyllama-1.1b-roofline"]
    assert loaded.entry("tinyllama-1.1b-roofline").provenance == "roofline"
    assert "== allocation for lam=" in out.stdout


def test_profile_points_reports_each_point_in_run_order():
    """The per-point probe on the CPU (smoke L6): one row per point in the
    order asked, a fresh backend per order, every decode chunk fenced."""
    from repro_torch.launch import profile_points
    rows = profile_points.main(["--device", "cpu", "--orders", "1,2", "2"],
                               log=lambda _: None)
    assert [(r["backend"], r["cap"]) for r in rows] == [(0, 1), (0, 2),
                                                        (1, 2)]
    for r in rows:
        assert r["chunks"] > 0 and r["svc_ms"] > 0.0 and r["rps"] > 0.0
        assert r["dispatch_ms"] >= 0.0 and "smi_samples" not in r
