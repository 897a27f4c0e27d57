"""The port engine's observability against the reference engine's, on the
CPU: one staggered schedule on a virtual clock, bridged fp32 weights, both
engines traced with rolling windows. Across FIFO dense sync, chunked paged
with prefix sharing and requeue preemption, the async tick and speculative
decoding with a 2-layer drafter, the port must give the reference's span
streams event by event (rid, name, t, attrs), its tick records in every
field the schedule decides (``TICK_FIELDS``), its registry, its window
names and snapshots, the same alerts from an ``SLOMonitor`` checked after
every tick, and a controller wired with ``burn_alerts=`` that re-solves
(reason ``burn_rate``) at the same ticks. The port alone: the dispatch
profiler samples every Nth tick and leaves the split NaN when off;
``summarize`` and ``kv_pool_stats`` agree with the registry; every request
carries a monotone span stream that opens with QUEUED and ends in one
terminal event, with PREEMPT before RESUME."""
import math

import numpy as np
import pytest

from _torch_parity import port_variants, reference_weights
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants
from repro.core.adapter import ControllerConfig as JConfig
from repro.core.adapter import InfAdapterController as JController
from repro.core.forecaster import MovingMaxForecaster as JForecaster
from repro.core.profiles import VariantProfile as JProfile
from repro.obs import BurnRateRule as JRule
from repro.obs import CollectingSink as JSink
from repro.obs import Observability as JObs
from repro.obs import SLOMonitor as JMonitor
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.core.adapter import ControllerConfig as PConfig
from repro_torch.core.adapter import InfAdapterController as PController
from repro_torch.core.forecaster import MovingMaxForecaster as PForecaster
from repro_torch.core.profiles import VariantProfile as PProfile
from repro_torch.obs import BurnRateRule as PRule
from repro_torch.obs import CollectingSink as PSink
from repro_torch.obs import Observability as PObs
from repro_torch.obs import SLOMonitor as PMonitor
from repro_torch.obs import dispatch_floor_summary
from repro_torch.obs import trace as ev
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

GEOMETRY = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                decode_chunk=2, kv_page_size=4, prefill_chunk=4,
                queue_cap=64)
TICK_FIELDS = ("backend", "t", "kind", "active", "prefilling", "queued",
               "admitted", "preempted", "completed", "pool_occupancy")

# one side's classes: (engine, request, obs, monitor, rule, sink,
# controller, config, forecaster, profile)
SIDES = {
    "ref": (JEngine, JRequest, JObs, JMonitor, JRule, JSink, JController,
            JConfig, JForecaster, JProfile),
    "port": (PEngine, PRequest, PObs, PMonitor, PRule, PSink, PController,
             PConfig, PForecaster, PProfile),
}

CASES = {
    "fifo_dense_sync": dict(kw=dict()),
    "chunked_paged_sharing_requeue": dict(
        kw=dict(scheduler="chunked", preemption="requeue", kv_cache="paged",
                kv_prefix_sharing=True), sharing=True),
    "async_chunked_requeue": dict(
        kw=dict(scheduler="chunked", preemption="requeue", async_tick=True)),
    "speculative": dict(kw=dict(speculative="small:big", spec_k=2),
                        n_variants=2, target="big"),
}


def _serve(side, case, n=8, seed=0, vocab=VOCAB, profile_dispatch=0):
    """Serve one staggered workload (a request a tick, then ticks until
    empty; even rids carry a 30 ms SLO, hopeless after a tick, odd rids 5 s)
    on a virtual clock advancing 50 ms a tick. After every tick, as
    ``run_serving_loop`` does, an SLO monitor checks the engine's windows
    and a controller wired to its sink may re-solve. Returns the engine
    and a log of ``(tick, t, alert tuples, re-solved)`` per tick."""
    (Engine, Request, Obs, Monitor, Rule, Sink, Controller, Config,
     Forecaster, Profile) = SIDES[side]
    c = CASES[case]
    jv = tiny_variants(c.get("n_variants", 1))
    target = c.get("target", "small")
    t = [0.0]
    kw = dict(GEOMETRY, clock=lambda: t[0],
              obs=Obs(trace=True, windows=True), **c["kw"])
    if side == "port":
        eng = Engine(port_variants(jv), device="cpu",
                     weights=reference_weights(jv),
                     profile_dispatch=profile_dispatch, **kw)
    else:
        eng = Engine(jv, **kw)
    sink = Sink()
    mon = Monitor(eng.windows, budget=0.05,
                  rules=(Rule(fast_s=1.0, slow_s=4.0, threshold=2.0),),
                  sinks=(sink,), cooldown_s=0.5, min_requests=2)
    # one variant that the solver always keeps at one unit: a re-solve
    # re-applies the same allocation, so the schedule stays the engine's
    prof = Profile(name=target, accuracy=75.0, rt=0.0, th_slope=100.0,
                   th_intercept=0.0, lat_base_ms=1.0, lat_k_ms=1.0,
                   max_units=1)
    ctrl = Controller({target: prof}, Forecaster(window=10),
                      Config(interval_s=30.0, budget=1, slo_ms=1000.0,
                             reactive=False), burn_alerts=sink)
    ctrl.monitor.record(0.0, 1)
    ctrl.step(0.0, eng)
    assert set(eng.backends) == {target}
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PROMPT_LEN // 2)
    log = []

    def tick(i):
        eng.step(t[0])
        fired = mon.check(t[0])
        d = None
        if fired:
            ctrl.monitor.advance_to(t[0])
            d = ctrl.maybe_react(t[0], eng)
        log.append((i, t[0], [(a.slo_class, a.rule, a.burn_fast,
                               a.burn_slow) for a in fired],
                    d is not None))
        t[0] += 0.05

    for i in range(n):
        if c.get("sharing") and i % 2:
            toks = np.concatenate([shared, rng.integers(
                0, vocab, PROMPT_LEN - len(shared))])
        else:
            toks = rng.integers(0, vocab, PROMPT_LEN)
        eng.submit(Request(rid=i, tokens=toks,
                           max_new=int(rng.integers(2, MAX_NEW + 1)),
                           arrival=t[0],
                           slo_ms=30.0 if i % 2 == 0 else 5000.0), target)
        tick(i)
    for i in range(n, n + 600):
        if not eng.backlog(t[0]) and not eng.in_flight():
            break
        tick(i)
    eng.flush_pending(t[0])
    assert len(eng.done) == n
    eng.t_end = t[0]
    eng.ctrl = ctrl
    eng.monitor = mon
    return eng, log


def _spans(eng):
    return {rid: [(e.rid, e.name, e.t, e.attrs) for e in evs]
            for rid, evs in eng.tracer.events.items()}


def _ticks(eng):
    out = []
    for r in eng.tracer.ticks:
        row = []
        for f in TICK_FIELDS:
            v = getattr(r, f)
            row.append("nan" if isinstance(v, float) and math.isnan(v)
                       else v)
        out.append(tuple(row))
    return out


def _registry(eng):
    return {s["name"]: s for s in (eng.metrics.get(n).snapshot()
                                   for n in eng.metrics.names())}


@pytest.mark.parametrize("case", list(CASES))
def test_port_observability_equals_reference(case):
    port, plog = _serve("port", case)
    ref, rlog = _serve("ref", case)
    assert {r.rid: [int(x) for x in r.output] for r in port.done} == \
        {r.rid: [int(x) for x in r.output] for r in ref.done}
    assert _spans(port) == _spans(ref)
    assert _ticks(port) == _ticks(ref)
    assert _registry(port) == _registry(ref)
    assert port.windows.names() == ref.windows.names()
    assert port.windows.snapshot(port.t_end) == ref.windows.snapshot(
        ref.t_end)
    assert plog == rlog
    assert [(d.t, d.reason) for d in port.ctrl.audit.entries] == \
        [(d.t, d.reason) for d in ref.ctrl.audit.entries]
    # the schedule exercised what it claims: alerts fired and the
    # controller re-solved on them
    assert port.monitor.alerts and any(x[3] for x in plog)
    assert "burn_rate" in {d.reason for d in port.ctrl.audit.entries}
    names = {e.name for evs in port.tracer.events.values() for e in evs}
    assert {ev.QUEUED, ev.ADMITTED, ev.COMPLETE} <= names
    if "preemption" in CASES[case]["kw"]:
        assert {ev.PREEMPT, ev.PREFILL_CHUNK} <= names
        if not CASES[case]["kw"].get("async_tick"):
            assert ev.RESUME in names    # a victim that had decoded
    if CASES[case]["kw"].get("kv_prefix_sharing"):
        assert ev.COW_BIND in names
    if "speculative" in CASES[case]["kw"]:
        assert {"spec.tokens_per_step", "spec.accept_rate"} <= set(
            port.windows.names())


# ------------------------------------------------------------ port alone
@pytest.fixture(scope="module")
def profiled():
    return {n: _serve("port", "fifo_dense_sync", profile_dispatch=n)[0]
            for n in (0, 2)}


def test_dispatch_profiler_samples_every_nth_tick(profiled):
    eng = profiled[2]
    recs = eng.tracer.ticks
    sampled = [r for r in recs if math.isfinite(r.dispatch_ms)]
    assert sampled and len(sampled) < len(recs)
    for i, r in enumerate(recs):       # one backend: record i is tick i + 1
        if (i + 1) % 2 or r.kind == "idle":
            assert math.isnan(r.dispatch_ms) and math.isnan(r.device_ms)
            assert math.isnan(r.host_sync_ms)
        else:
            assert r.dispatch_ms >= 0 and r.device_ms >= 0
            assert r.host_sync_ms >= 0
            assert (r.dispatch_ms + r.device_ms + r.host_sync_ms
                    <= r.exec_ms + 1e-6)
    summary = dispatch_floor_summary(recs)
    assert summary
    for d in summary.values():
        assert d["n_sampled"] >= 1
        assert 0.0 <= d["dispatch_frac"] <= 1.0
        assert 0.0 <= d["host_sync_frac"] <= 1.0
    # fencing changes no token
    assert {r.rid: list(r.output) for r in eng.done} == \
        {r.rid: list(r.output) for r in profiled[0].done}


def test_dispatch_profiler_off_leaves_nan(profiled):
    eng = profiled[0]
    assert eng.tracer.ticks
    assert all(math.isnan(r.dispatch_ms) for r in eng.tracer.ticks)
    assert dispatch_floor_summary(eng.tracer.ticks) == {}


def test_dispatch_profiler_needs_tracing():
    jv = tiny_variants(1)
    eng = PEngine(port_variants(jv), device="cpu",
                  weights=reference_weights(jv), profile_dispatch=1,
                  **GEOMETRY)
    eng.apply_allocation(0.0, {"small": 1})
    eng.submit(PRequest(rid=0, tokens=np.arange(PROMPT_LEN), max_new=4,
                        arrival=0.0), "small")
    eng.drain(0.0)
    assert not eng.tracer.on and eng.tracer.ticks == []
    assert eng.backends["small"].exec_split is None


def _spanned(kw):
    eng, _ = _serve("port", kw)
    for r in eng.done:
        names = [e.name for e in r.spans]
        assert [e.t for e in r.spans] == sorted(e.t for e in r.spans)
        assert names[0] == ev.QUEUED and ev.ADMITTED in names
        assert names[-1] in ev.TERMINAL_EVENTS
        assert not ev.TERMINAL_EVENTS & set(names[:-1])
        if ev.RESUME in names:
            assert names.index(ev.PREEMPT) < names.index(ev.RESUME)
    return eng


def test_engine_summarize_agrees_with_registry():
    eng = _spanned("fifo_dense_sync")
    s = eng.summarize(slo_ms=1e6, best_accuracy=70.0)
    m = eng.metrics
    assert s["n_requests"] == int(m.value("requests.completed")) == 8
    assert s["p99_ms"] == pytest.approx(m.get("request.latency_ms")
                                        .percentile(99))
    assert int(m.value("requests.submitted")) == 8
    attr = sum(b.prefill_tokens_total for b in eng.backends.values())
    assert int(m.value("engine.prefill_tokens_total")) == attr > 0


def test_kv_pool_stats_registry_backed():
    eng = _spanned("chunked_paged_sharing_requeue")
    stats = eng.kv_pool_stats()
    m = eng.metrics
    assert stats["prefix_lookups"] == int(m.value("kv.prefix_lookups")) > 0
    assert stats["fresh_pages_allocated"] == \
        int(m.value("kv.pages_allocated")) > 0
    assert stats["used_pages"] == 0
    assert int(m.value("requests.preempted")) > 0


def test_rejections_are_traced_and_windowed():
    """A full queue and an engine with nothing loaded reject with a
    REJECTED span and the windowed ``requests.rejected`` counter, as the
    reference's ``submit``."""
    jv = tiny_variants(1)
    out = {}
    for side in ("port", "ref"):
        Engine, Request, Obs = SIDES[side][:3]
        kw = dict(GEOMETRY, queue_cap=1, clock=lambda: 1.0,
                  obs=Obs(trace=True, windows=True))
        eng = (Engine(port_variants(jv), device="cpu",
                      weights=reference_weights(jv), **kw)
               if side == "port" else Engine(jv, **kw))
        toks = np.arange(PROMPT_LEN)
        assert not eng.submit(Request(rid=0, tokens=toks, max_new=2,
                                      arrival=0.0), "small")
        eng.apply_allocation(0.0, {"small": 1})
        assert eng.submit(Request(rid=1, tokens=toks, max_new=2,
                                  arrival=0.0), "small")
        assert not eng.submit(Request(rid=2, tokens=toks, max_new=2,
                                      arrival=0.0), "small")
        out[side] = (_spans(eng), eng.windows.snapshot(1.0))
    assert out["port"] == out["ref"]
    spans = out["port"][0]
    assert spans[0][-1][1] == spans[2][-1][1] == ev.REJECTED
