"""The port's observability layer (``repro_torch.obs``) on its own, mirroring
the unit cases of tests/test_obs.py and tests/test_obs_online.py: counters,
gauges and histograms, the rolling windows (expiry, clamps, ring reset,
sample caps), ``slo_class_key``, the burn-rate monitor (both windows, min
requests, cooldown), the flight recorder (round trip, bounded rings, rate
limit, ``FlightTrigger`` sanitising), the tracer's caps and drop counters,
the chrome-trace validator, export and its CLI's ``--assert-zero``, and the
audit's ``attach_measured`` edges. Each copied module is held equal to the
reference's source once ``repro_torch`` reads as ``repro``, so the copies
cannot drift. The engine-fed cases run the port's engine on the CPU."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from _torch_parity import port_variants
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants
from repro_torch.obs import (Alert, BurnRateRule, CollectingSink,
                             DecisionAudit, FlightRecorder, FlightTrigger,
                             MetricsRegistry, MetricWindows, NULL_REGISTRY,
                             NULL_WINDOWS, NullInstrument, Observability,
                             SLOMonitor, TickRecord, Tracer,
                             attach_from_requests, dispatch_floor_summary,
                             predict_outputs, slo_class_key, to_chrome_trace,
                             validate_chrome_trace)
from repro_torch.obs import trace as ev
from repro_torch.obs.export import (assert_zero, summarize_file,
                                    validate_metrics_file,
                                    validate_trace_file, write_metrics_jsonl)
from repro_torch.obs.slo import bad_metric, good_metric
from repro_torch.obs.windows import WindowedCounter, WindowedHistogram

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ no drift
@pytest.mark.parametrize("module", ["__init__", "audit", "export",
                                    "flightrec", "profiler", "registry",
                                    "slo", "trace", "windows"])
def test_copied_module_equals_reference(module):
    port = (ROOT / "src/repro_torch/obs" / f"{module}.py").read_text()
    ref = (ROOT / "src/repro/obs" / f"{module}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


# --------------------------------------------------------------- registry
def test_counter_gauge_semantics():
    m = MetricsRegistry()
    m.inc("a.total")
    m.inc("a.total", 4)
    assert m.value("a.total") == 5.0
    with pytest.raises(ValueError):
        m.counter("a.total").inc(-1)
    m.set("a.gauge", 3.5)
    m.set("a.gauge", 2.0)
    assert m.value("a.gauge") == 2.0
    assert m.value("missing", default=-1.0) == -1.0
    with pytest.raises(TypeError):
        m.gauge("a.total")


def test_histogram_percentiles_match_numpy():
    m = MetricsRegistry()
    xs = np.random.default_rng(0).exponential(10.0, 500)
    h = m.histogram("lat")
    for x in xs:
        h.observe(x)
    for p in (50, 95, 99):
        assert h.percentile(p) == pytest.approx(np.percentile(xs, p))
    assert h.count == 500 and h.mean == pytest.approx(xs.mean())
    snap = h.snapshot()
    assert snap["kind"] == "histogram" and "p99" in snap


def test_histogram_reservoir_bounded():
    h = MetricsRegistry(reservoir=64).histogram("big")
    for x in range(10_000):
        h.observe(float(x))
    assert h.count == 10_000 and len(h._res) <= 64
    assert 1_000 < h.percentile(50) < 9_000


def test_disabled_registry_is_noop():
    m = MetricsRegistry(enabled=False)
    c = m.counter("x")
    assert isinstance(c, NullInstrument)
    assert m.counter("y") is c
    m.inc("x", 5)
    m.observe("h", 1.0)
    m.set("g", 2.0)
    assert m.snapshot() == [] and m.value("x") == 0.0
    assert NULL_REGISTRY.counter("z") is c


def test_registry_dump_and_reset(tmp_path):
    m = MetricsRegistry()
    m.inc("requests.completed", 3)
    m.observe("request.latency_ms", 12.0)
    path = str(tmp_path / "m.jsonl")
    n = write_metrics_jsonl(path, m, extra=[{"name": "run", "kind": "meta"}])
    assert n == 3 and validate_metrics_file(path) == 3
    m.reset()
    assert m.names() == []
    write_metrics_jsonl(str(tmp_path / "e.jsonl"), m)
    with pytest.raises(ValueError):          # an empty dump fails
        validate_metrics_file(str(tmp_path / "e.jsonl"))


# ----------------------------------------------------------------- tracer
def _toy_tracer():
    tr = Tracer(enabled=True)
    tr.event(1, ev.QUEUED, 0.0)
    tr.event(1, ev.ADMITTED, 1.0, slot=0)
    tr.event(1, ev.PREFILL_COMPLETE, 2.0)
    tr.event(1, ev.COMPLETE, 5.0, latency_ms=5000.0)
    tr.event(2, ev.QUEUED, 0.5)
    tr.event(2, ev.ADMITTED, 1.5, slot=1)
    tr.event(2, ev.PREEMPT, 2.5, action="requeue")
    tr.event(2, ev.RESUME, 3.5, slot=0)
    tr.event(2, ev.PREFILL_COMPLETE, 4.0)
    tr.event(2, ev.DROP, 6.0)
    for i in range(3):
        tr.tick(TickRecord(backend="b0", t=float(i), kind="decode",
                           preempt_ms=0.0, admit_ms=0.1, exec_ms=1.0,
                           active=2, prefilling=0, queued=1, admitted=1,
                           preempted=0, completed=0))
    return tr


def test_chrome_trace_round_trip():
    obj = to_chrome_trace(_toy_tracer(), label="t")
    n = validate_chrome_trace(obj)
    assert n == len(obj["traceEvents"]) > 0
    assert validate_chrome_trace(json.loads(json.dumps(obj))) == n
    assert {e["pid"] for e in obj["traceEvents"] if e["ph"] != "M"} == {1, 2}
    slices = [e for e in obj["traceEvents"]
              if e["ph"] == "X" and e["pid"] == 1]
    assert any(e["name"] == "preempted" for e in slices)
    assert all(e["dur"] >= 0 for e in slices)


@pytest.mark.parametrize("mangle", [
    lambda o: o.pop("traceEvents"),
    lambda o: o["traceEvents"][0].pop("ph"),
    lambda o: o["traceEvents"][0].update(ph="Z"),
    lambda o: next(e for e in o["traceEvents"]
                   if e["ph"] == "X").update(dur=-1.0),
    lambda o: next(e for e in o["traceEvents"] if e["ph"] == "X").pop("dur"),
], ids=["no_events", "no_ph", "bad_ph", "negative_dur", "no_dur"])
def test_validate_rejects_malformed(mangle):
    obj = json.loads(json.dumps(to_chrome_trace(_toy_tracer(), label="t")))
    mangle(obj)
    with pytest.raises(ValueError):
        validate_chrome_trace(obj)


def test_tracer_caps_drop_counted():
    tr = Tracer(enabled=True, max_events=10)
    for i in range(25):
        tr.event(i, ev.QUEUED, float(i))
    assert tr.n_events == 10 and tr.dropped_events == 15
    s = tr.summary()
    assert s["events"] == 10 and s["dropped_events"] == 15


def test_tracer_drop_counter_increments_past_cap():
    obs = Observability(trace=True, max_events=2)
    for i in range(5):
        obs.tracer.event(0, "queued", float(i))
    assert obs.metrics.value("obs.spans_dropped") == 3.0


def test_dropped_spans_still_reach_flight_ring(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path))
    obs = Observability(trace=True, max_events=2, flight=fr)
    for i in range(6):
        obs.tracer.event(0, "queued", float(i))
    assert obs.metrics.value("obs.spans_dropped") == 4.0
    assert len(fr.spans) == 6


def test_bundle_modes():
    off = Observability.disabled()
    assert not off.metrics.enabled and not off.tracing and not off.windows.on
    fl = Observability(flight=FlightRecorder())
    assert fl.tracing                        # the flight ring rides the tracer
    assert fl.metrics.value("obs.spans_dropped") == 0.0
    assert Observability(windows=True).windows.on


# ------------------------------------------------------------------ audit
class _Prof:
    def __init__(self, p99, th):
        self._p99, self._th = p99, th

    def p99_ms(self, n):
        return self._p99

    def throughput(self, n):
        return self._th * n


class _Alloc:
    def __init__(self, units, quotas):
        self.units, self.quotas = units, quotas


def test_predict_outputs():
    profiles = {"fast": _Prof(100.0, 10.0), "slow": _Prof(900.0, 5.0)}
    pred = predict_outputs(profiles, _Alloc({"fast": 2, "slow": 1},
                                            {"fast": 15.0, "slow": 5.0}),
                           lam=20.0, slo_ms=500.0)
    assert pred["p99_ms"] == pytest.approx(0.75 * 100 + 0.25 * 900)
    assert pred["capacity_rps"] == pytest.approx(25.0)
    assert pred["goodput"] == pytest.approx(0.75)


def _audit_with(times):
    a = DecisionAudit()
    for t in times:
        a.record(t, "C", {"lam": 1.0},
                 {"units": {"m": 1}, "predicted": {"p99_ms": 100.0,
                                                   "goodput": 0.9}})
    return a


def test_attach_measured_zero_decisions():
    assert DecisionAudit().attach_measured([1.0], [50.0], [True]) == 0


def test_attach_measured_zero_requests():
    a = _audit_with([0.0])
    assert a.attach_measured([], [], []) == 0
    assert a.entries[0].measured is None


def test_attach_measured_single_decision_takes_all_and_warmup():
    a = _audit_with([10.0])
    assert a.attach_measured([1.0, 11.0, 20.0], [50.0, 60.0, 70.0],
                             [True, True, False]) == 1
    m = a.entries[0].measured
    assert m["n_requests"] == 3 and m["goodput"] == pytest.approx(2 / 3)


def test_attach_measured_out_of_order_decisions_sorted():
    a = _audit_with([10.0, 0.0])
    assert a.attach_measured([1.0, 12.0], [50.0, 60.0], [True, False]) == 2
    by_t = {e.t: e.measured for e in a.entries}
    assert by_t[0.0]["p50_ms"] == pytest.approx(50.0)
    assert by_t[10.0]["p50_ms"] == pytest.approx(60.0)


def test_attach_measured_empty_window_marked_not_counted():
    a = _audit_with([0.0, 10.0])
    assert a.attach_measured([1.0], [50.0], [True]) == 1
    assert a.entries[1].measured == {"n_requests": 0}


def test_attach_from_requests_duck_typing():
    class R:
        def __init__(self, arrival, completion, slo_ms=0.0,
                     service_start=1.0, dropped=False):
            self.arrival, self.completion = arrival, completion
            self.slo_ms, self.service_start = slo_ms, service_start
            self.dropped = dropped

    audit = _audit_with([0.0])
    reqs = [R(0.0, 0.1, slo_ms=200.0), R(1.0, 2.0, slo_ms=200.0),
            R(2.0, 2.1, dropped=True), R(3.0, 3.05, service_start=0.0)]
    assert attach_from_requests(audit, reqs, default_slo_ms=100.0) == 1
    assert audit.entries[0].measured["goodput"] == pytest.approx(0.25)
    assert attach_from_requests(None, reqs) == 0


# ---------------------------------------------------------------- windows
def test_windowed_counter_totals_and_expiry():
    c = WindowedCounter("x", window_s=10.0, n_buckets=10)
    c.inc(0.5)
    c.inc(1.5, 2)
    c.inc(2.5)
    assert c.total(2.5) == 4.0
    assert c.total(2.5, window_s=1.0) == 1.0
    assert c.total(2.5, window_s=2.0) == 3.0
    assert c.total(12.6) == 0.0 and c.rate(12.6) == 0.0


def test_windowed_counter_backward_stamp_clamps_and_negative_raises():
    c = WindowedCounter("x", window_s=10.0, n_buckets=10)
    c.inc(5.0)
    c.inc(1.0)
    assert c.total(5.0, window_s=1.0) == 2.0
    with pytest.raises(ValueError):
        c.inc(6.0, -1)


def test_windowed_counter_large_clock_jump_resets_ring():
    c = WindowedCounter("x", window_s=10.0, n_buckets=10)
    for t in range(10):
        c.inc(float(t))
    assert c.total(9.0) == 10.0
    c.inc(1e6)
    assert c.total(1e6) == 1.0


def test_windowed_histogram_stats_and_expiry():
    h = WindowedHistogram("lat", window_s=10.0, n_buckets=10)
    for i, v in enumerate([5.0, 7.0, 10.0, 12.0]):
        h.observe(float(i), v)
    assert h.count(3.0) == 4
    assert h.mean(3.0) == pytest.approx(8.5)
    assert h.percentile(3.0, 50) == pytest.approx(8.5)
    assert h.count(3.0, window_s=1.0) == 1
    assert h.count(30.0) == 0
    assert math.isnan(h.mean(30.0)) and math.isnan(h.percentile(30.0, 99))


def test_windowed_histogram_sample_cap_keeps_exact_count():
    h = WindowedHistogram("lat", window_s=10.0, n_buckets=10, cap=4)
    for _ in range(20):
        h.observe(0.5, 1.0)
    assert h.count(0.5) == 20 and h.mean(0.5) == pytest.approx(1.0)


def test_metric_windows_map_and_null():
    w = MetricWindows(window_s=10.0, n_buckets=10)
    w.inc("a", 1.0, 2)
    w.observe("b", 1.0, 3.0)
    assert w.on and w.names() == ["a", "b"]
    assert w.counter("a").total(1.0) == 2.0
    assert w.rate("a", 1.0, window_s=10.0) == pytest.approx(0.2)
    assert w.rate("b", 1.0) == 0.0
    assert not NULL_WINDOWS.on
    NULL_WINDOWS.inc("a", 0.0)
    assert NULL_WINDOWS.names() == []


def test_window_snapshot_rows_validate(tmp_path):
    w = MetricWindows(window_s=10.0, n_buckets=10)
    w.inc("req", 1.0, 3)
    w.observe("lat", 1.0, 9.0)
    rows = w.snapshot(1.0)
    assert {r["kind"] for r in rows} == {"window_counter",
                                         "window_histogram"}
    p = tmp_path / "m.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert validate_metrics_file(str(p)) == 2


# -------------------------------------------------------------------- slo
def test_slo_class_key_formats():
    assert slo_class_key(750.0) == "750"
    assert slo_class_key(1500.5) == "1500.5"
    assert slo_class_key(0.0) == "none" and slo_class_key(-1.0) == "none"
    assert good_metric("750") == "slo.class.750.good"
    assert bad_metric("none") == "slo.class.none.bad"


def _fed_windows(goods, bads, cls="750"):
    w = MetricWindows(window_s=60.0, n_buckets=60)
    for t, n in goods:
        w.inc(good_metric(cls), t, n)
    for t, n in bads:
        w.inc(bad_metric(cls), t, n)
    return w


def test_burn_rate_monitor_fires_on_both_windows():
    w = _fed_windows(goods=[], bads=[(t, 2) for t in range(0, 31)])
    sink = CollectingSink()
    mon = SLOMonitor(w, budget=0.05,
                     rules=(BurnRateRule(fast_s=5.0, slow_s=30.0),),
                     sinks=(sink,), min_requests=5)
    fired = mon.check(30.0)
    assert len(fired) == 1
    a = fired[0]
    assert a.slo_class == "750" and a.kind == "burn_rate"
    assert a.burn_fast == pytest.approx(20.0)
    assert a.burn_slow == pytest.approx(20.0)
    assert sink.pending() == 1
    assert sink.pop_pending() == [a] and sink.pending() == 0
    assert sink.alerts == [a]


def test_burn_rate_needs_slow_window_too():
    w = _fed_windows(goods=[(t, 10) for t in range(0, 27)],
                     bads=[(t, 2) for t in (27, 28, 29)])
    mon = SLOMonitor(w, budget=0.05,
                     rules=(BurnRateRule(fast_s=3.0, slow_s=30.0),))
    assert mon.check(29.5) == []


def test_burn_rate_min_requests_silences_noise():
    w = _fed_windows(goods=[], bads=[(0.5, 2)])
    mon = SLOMonitor(w, budget=0.05,
                     rules=(BurnRateRule(fast_s=5.0, slow_s=30.0),),
                     min_requests=5)
    assert mon.burn_rate("750", 1.0, 5.0) is None
    assert mon.check(1.0) == []


def test_burn_rate_cooldown_rearms():
    w = _fed_windows(goods=[], bads=[(float(t), 2) for t in range(0, 60)])
    mon = SLOMonitor(w, budget=0.05,
                     rules=(BurnRateRule(fast_s=5.0, slow_s=30.0),),
                     cooldown_s=10.0)
    assert len(mon.check(30.0)) == 1
    assert mon.check(35.0) == []
    assert len(mon.check(41.0)) == 1
    assert len(mon.alerts) == 2


def test_monitor_disabled_windows_noop():
    assert SLOMonitor(NULL_WINDOWS).check(0.0) == []


# ---------------------------------------------------- controller reaction
class _Cluster:
    """The least ``ClusterAPI`` the controller steps against."""

    def __init__(self):
        self.units = {}

    def apply_allocation(self, t, units):
        self.units = dict(units)

    def loaded_variants(self, t):
        return {m for m, n in self.units.items() if n > 0}

    def backlog(self, t):
        return 0.0


def _mini_controller(burn_alerts=None, reactive=False):
    from repro_torch.core.adapter import (ControllerConfig,
                                          InfAdapterController)
    from repro_torch.core.forecaster import MovingMaxForecaster
    from repro_torch.core.profiles import paper_resnet_profiles
    cfg = ControllerConfig(interval_s=30.0, budget=8, slo_ms=750.0,
                           reactive=reactive)
    return InfAdapterController(paper_resnet_profiles(),
                                MovingMaxForecaster(window=10), cfg,
                                burn_alerts=burn_alerts)


def test_maybe_react_resolves_on_burn_alert_without_reactive():
    sink = CollectingSink()
    ctrl, cl = _mini_controller(burn_alerts=sink), _Cluster()
    ctrl.monitor.record(0.0, 5)
    ctrl.step(0.0, cl)
    assert ctrl.maybe_react(3.0, cl) is None
    sink.emit(Alert(t=3.0, slo_class="750", rule="fast5s/slow30s",
                    burn_fast=20.0, burn_slow=20.0, budget=0.05))
    d = ctrl.maybe_react(3.0, cl)
    assert d is not None and d.t == 3.0
    assert ctrl.audit.entries[-1].reason == "burn_rate"
    assert sink.pending() == 0
    ctrl.step(30.0, cl)
    assert ctrl.audit.entries[-1].reason == "interval"


def test_maybe_react_without_sink_keeps_legacy_gate():
    ctrl, cl = _mini_controller(), _Cluster()
    ctrl.monitor.record(0.0, 5)
    ctrl.step(0.0, cl)
    assert ctrl.maybe_react(3.0, cl) is None


# -------------------------------------------------------- flight recorder
def test_flight_recorder_rings_are_bounded():
    from repro_torch.obs.trace import SpanEvent
    fr = FlightRecorder(max_spans=4, max_ticks=2, max_metric_snaps=2)
    for i in range(10):
        fr.push_event(SpanEvent(rid=i, name="queued", t=float(i)))
    assert len(fr.spans) == 4 and fr.spans[0].rid == 6
    for i in range(5):
        fr.push_tick(TickRecord(t=float(i), backend="b", kind="decode"))
    assert len(fr.ticks) == 2 and fr.ticks[0].t == 3.0


def test_flight_recorder_rate_limit_and_max_dumps(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), min_interval_s=5.0,
                        max_dumps=3)
    assert fr.trigger("a", 0.0) is not None
    assert fr.trigger("a", 2.0) is None
    assert fr.trigger("b", 2.0) is not None
    p3 = fr.trigger("a", 7.0)
    assert p3 is not None and p3.endswith("FLIGHT_a_2.json")
    assert fr.trigger("c", 100.0) is None
    assert len(fr.dumps) == 3


def test_flight_trigger_sanitizes_reason(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0)
    p = fr.trigger("burn rate: 750/ms!", 0.0)
    assert os.path.basename(p) == "FLIGHT_burn_rate_750_ms.json"


def test_alert_sink_flight_trigger(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0)
    FlightTrigger(fr).emit(Alert(t=1.0, slo_class="750",
                                 rule="fast5s/slow30s", burn_fast=4.0,
                                 burn_slow=3.0, budget=0.05))
    assert os.path.basename(fr.dumps[0]) == "FLIGHT_burn_rate_750.json"
    with open(fr.dumps[0]) as f:
        assert json.load(f)["otherData"]["burn_fast"] == 4.0


def test_dispatch_floor_summary_of_records():
    recs = [TickRecord(backend="b", t=float(i), kind="decode", exec_ms=4.0,
                       dispatch_ms=1.0, device_ms=2.0, host_sync_ms=1.0)
            for i in range(3)]
    recs.append(TickRecord(backend="b", t=3.0, kind="decode", exec_ms=4.0))
    s = dispatch_floor_summary(recs)
    assert s["decode"]["n_sampled"] == 3
    assert s["decode"]["dispatch_frac"] == pytest.approx(0.25)
    assert dispatch_floor_summary(recs[3:]) == {}


# ------------------------------------------- fed by the port's engine
def _run_windowed_engine(slo_ms, **kw):
    """The port engine at the tiny geometry on a virtual clock, traced with
    rolling windows: six staggered requests, drained."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    clk = [0.0]
    eng = InProcessServingEngine(
        port_variants(tiny_variants(1)), device="cpu", max_batch=2,
        prompt_len=PROMPT_LEN, max_new=MAX_NEW, decode_chunk=2,
        kv_page_size=4, queue_cap=64, clock=lambda: clk[0],
        obs=Observability(trace=True, windows=True), **kw)
    eng.apply_allocation(0.0, {"small": 1})
    rng = np.random.default_rng(1)
    for i in range(6):
        eng.submit(Request(rid=i, tokens=rng.integers(0, VOCAB, PROMPT_LEN),
                           max_new=MAX_NEW, arrival=clk[0], slo_ms=slo_ms),
                   None)
        eng.step(clk[0])
        clk[0] += 0.01
    for _ in range(500):
        if not (eng.backlog(clk[0]) or eng.in_flight()):
            break
        eng.step(clk[0])
        clk[0] += 0.01
    assert len(eng.done) == 6
    return eng, clk[0]


@pytest.fixture(scope="module")
def windowed_engine():
    return _run_windowed_engine(750.0)


def test_flight_recorder_dump_roundtrip(tmp_path, windowed_engine):
    eng, t = windowed_engine
    fr = FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0)
    for evs in eng.tracer.events.values():
        for e in evs:
            fr.push_event(e)
    for rec in eng.tracer.ticks:
        fr.push_tick(rec)
    fr.snap_metrics(t, eng.metrics)
    path = fr.trigger("unit_test", t, extra={"note": "roundtrip"})
    assert os.path.basename(path) == "FLIGHT_unit_test.json"
    assert validate_trace_file(path) > 0
    with open(path) as f:
        obj = json.load(f)
    assert obj["otherData"]["flight_reason"] == "unit_test"
    assert obj["otherData"]["note"] == "roundtrip"
    assert any(e.get("ph") == "C" and e.get("pid") == 3
               for e in obj["traceEvents"])


def test_tracer_drop_counters_zero_on_normal_run(tmp_path, windowed_engine):
    eng, _ = windowed_engine
    assert eng.metrics.value("obs.spans_dropped") == 0.0
    assert eng.metrics.value("obs.ticks_dropped") == 0.0
    p = tmp_path / "m.jsonl"
    write_metrics_jsonl(str(p), eng.metrics)
    assert_zero(str(p), "obs.spans_dropped")
    assert_zero(str(p), "obs.ticks_dropped")


def test_export_summarize_metrics_and_audit(tmp_path, windowed_engine):
    eng, _ = windowed_engine
    mp = tmp_path / "m.jsonl"
    write_metrics_jsonl(str(mp), eng.metrics)
    out = summarize_file(str(mp))
    assert "requests.completed" in out and "p99" in out
    a = _audit_with([0.0, 30.0])
    a.attach_measured([1.0, 31.0], [50.0, 60.0], [True, True])
    ap = tmp_path / "a.jsonl"
    a.to_jsonl(str(ap))
    out = summarize_file(str(ap))
    assert "interval" in out and "m:1" in out
    (tmp_path / "x.jsonl").write_text(json.dumps({"t": 1}) + "\n")
    with pytest.raises(ValueError):
        summarize_file(str(tmp_path / "x.jsonl"))


def test_export_cli_assert_zero(tmp_path, windowed_engine):
    from repro_torch.obs.export import main
    eng, _ = windowed_engine
    mp = tmp_path / "m.jsonl"
    write_metrics_jsonl(str(mp), eng.metrics)
    assert main(["--validate-metrics", str(mp),
                 "--assert-zero", "obs.spans_dropped",
                 "--assert-zero", "obs.ticks_dropped",
                 "--summarize", str(mp)]) == 0
    assert main(["--validate-metrics", str(mp),
                 "--assert-zero", "requests.completed"]) == 1
    assert main(["--assert-zero", "obs.spans_dropped"]) == 1


def test_export_module_cli_runs(tmp_path, windowed_engine):
    """``python -m repro_torch.obs.export`` as a command: 0 on valid
    reports with zero drops, nonzero on a counter that is not zero."""
    from repro_torch.obs.export import write_chrome_trace
    eng, _ = windowed_engine
    tp, mp = tmp_path / "t.json", tmp_path / "m.jsonl"
    write_chrome_trace(str(tp), eng.tracer)
    write_metrics_jsonl(str(mp), eng.metrics)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.obs.export",
            "--validate-trace", str(tp), "--validate-metrics", str(mp)]
    ok = subprocess.run(base + ["--assert-zero", "obs.spans_dropped"],
                        env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    bad = subprocess.run(base + ["--assert-zero", "requests.completed"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1


def test_engine_windows_feed_the_burn_monitor():
    """An impossible SLO turns every completion bad; the monitor fires on
    the port engine's windows (the reference's engine/sim parity case, on
    the port's side)."""
    eng, t = _run_windowed_engine(1e-6)
    names = set(eng.windows.names())
    assert {"requests.submitted", "requests.completed",
            "request.latency_ms"} <= names
    cls = slo_class_key(1e-6)
    assert eng.windows.counter(bad_metric(cls)).total(t) == 6
    mon = SLOMonitor(eng.windows, budget=0.05,
                     rules=(BurnRateRule(fast_s=5.0, slow_s=30.0),),
                     min_requests=3)
    fired = mon.check(t)
    assert len(fired) == 1 and fired[0].slo_class == cls
    assert fired[0].burn_fast == pytest.approx(20.0)


def test_launcher_wires_observability(tmp_path):
    """``launch.serve.serve`` with ``--trace --profile-dispatch
    --burn-rate-alerts --flight-dir`` on the CPU smoke ladder, at an SLO
    the given profiles call feasible and no request meets: every alert
    makes the controller re-solve (reason ``burn_rate``) and dumps the
    flight ring; the trace, metrics and audit reports validate with zero
    drop counters."""
    from repro_torch.core.profiles import VariantProfile
    from repro_torch.launch import serve as launcher
    args = launcher.parse_args([
        "--device", "cpu", "--seconds", "6", "--interval", "3",
        "--slo-ms", "1", "--trace", "--profile-dispatch", "2",
        "--burn-rate-alerts", "--flight-dir", str(tmp_path / "flight"),
        "--report-dir", str(tmp_path / "reports")])
    variants = launcher.build_ladder(args.arch)
    profiles = {n: VariantProfile(name=n, accuracy=a, rt=0.0,
                                  th_slope=100.0, th_intercept=0.0,
                                  lat_base_ms=0.1, lat_k_ms=0.1, max_units=1)
                for n, (_, a) in variants.items()}
    out = launcher.serve(args, profiles=profiles, log=lambda m: None)
    eng, s = out["engine"], out["summary"]
    assert s is not None and s["pending"] == 0
    alerts = out["slo_monitor"].alerts
    assert alerts and out["burn_resolves"] == len(alerts)
    assert {a.slo_class for a in alerts} == {slo_class_key(1.0)}
    assert out["flight"].dumps
    for p in out["flight"].dumps:
        assert validate_trace_file(p) > 0
    rep = out["reports"]
    assert validate_trace_file(rep["TRACE_engine.json"]) > 0
    assert validate_metrics_file(rep["METRICS_engine.jsonl"]) > 0
    for c in ("obs.spans_dropped", "obs.ticks_dropped"):
        assert_zero(rep["METRICS_engine.jsonl"], c)
    audit = [json.loads(line) for line in
             open(rep["AUDIT_decisions.jsonl"]) if line.strip()]
    assert sum(d["reason"] == "burn_rate" for d in audit) == len(alerts)
    sampled = [r for r in eng.tracer.ticks if math.isfinite(r.dispatch_ms)]
    assert sampled and all(r.device_ms >= 0 for r in sampled)
