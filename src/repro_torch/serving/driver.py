"""Shared wall-clock serving loop for the real-execution drivers.

``repro_torch.launch.serve`` and ``chip_smoke.py``'s serve phases both
replay a load curve against an ``InProcessServingEngine`` behind the
InfAdapter control loop; this module holds the one copy of that loop so
the drivers can't drift. Poisson arrivals are scaled by the *measured* tick
duration, so offered load tracks λ(t) regardless of how fast the engine
ticks.

Clock domains: every latency-bearing stamp — ``Request.arrival`` here,
``service_start``/``completion`` inside the engine — is taken from the
**engine's own clock** (``engine.clock``, ``time.time`` by default), so
queue waits and latencies always subtract same-domain values. Construct the
engine with ``clock=ElapsedClock()`` to put those stamps on the loop's
elapsed-seconds timeline (the domain control steps, fault schedules, and
the monitor already use); the loop resets that clock at t=0.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.audit import attach_from_requests
from repro_torch.serving.api import Request, ServingAPI


class ElapsedClock:
    """Callable clock returning seconds since construction (or the latest
    ``reset``). Hand one to ``InProcessServingEngine(clock=...)`` so every
    request stamp shares the serving loop's elapsed-time domain instead of
    absolute epoch seconds."""

    def __init__(self):
        self.t0 = time.time()

    def reset(self) -> None:
        self.t0 = time.time()

    def __call__(self) -> float:
        return time.time() - self.t0


def trace_load(rate: np.ndarray, scale: float = 1.0,
               repeat: bool = False) -> Callable[[float], float]:
    """λ(t) from a recorded per-second rate trace:
    second ``int(now)`` of the trace, scaled by ``scale`` (smoke-size a
    Twitter-shaped trace down to what a CPU engine sustains). ``repeat``
    wraps around instead of holding the last second."""
    arr = np.asarray(rate, float)
    assert len(arr) > 0

    def load(now: float) -> float:
        i = int(max(now, 0.0))
        i = i % len(arr) if repeat else min(i, len(arr) - 1)
        return float(arr[i]) * scale
    return load


def run_serving_loop(engine: ServingAPI, ctrl, *, seconds: float,
                     interval: float, load_fn: Callable[[float], float],
                     seed: int = 0, prompt_len: int = 16, max_new: int = 8,
                     vocab: int = 256, tick_sleep: float = 0.05,
                     faults=None, slo_ms: float = 0.0,
                     slo_monitor=None,
                     log: Optional[Callable[[str], None]] = print) -> int:
    """Drive ``engine`` under ``ctrl`` for ``seconds`` of wall-clock time.

    ``load_fn(now)`` gives the offered rate λ (req/s) at elapsed time
    ``now`` (see ``trace_load`` to replay a recorded trace). The controller
    steps every ``interval`` seconds; the engine is ticked (admission + one
    decode chunk) every ``tick_sleep``, and drained before returning.
    ``faults`` (a fault schedule with ``next_t()`` and ``apply_due(now,
    engine)``, event times in elapsed seconds) is injected into
    fabric-backed engines as wall-clock time passes; the port has no such
    engine until the replica fabric (the fabric half of ROADMAP A3) lands.
    ``slo_ms`` stamps each request's deadline (deadline-aware schedulers
    and the goodput metric read it). Returns the number of requests
    submitted.

    ``slo_monitor`` (a ``repro_torch.obs.slo.SLOMonitor`` over the engine's
    windowed metrics) turns on the online reaction path: every iteration
    the monitor's burn-rate rules are checked and ``ctrl.maybe_react`` is
    called, so a controller wired with ``burn_alerts=`` re-solves on a
    burn-rate breach *between* interval steps. Without it the loop is
    purely interval-driven (unchanged legacy behavior).

    Arrivals are stamped from the engine's clock — the same clock the
    engine stamps ``service_start``/``completion`` from — so latencies and
    queue waits never mix clock domains (regression-tested).
    """
    rng = np.random.default_rng(seed)
    clk = getattr(engine, "clock", time.time)
    if isinstance(clk, ElapsedClock):
        clk.reset()          # elapsed stamps align with the loop's t=0
    t_start = time.time()
    rid = 0
    next_ctrl = 0.0
    last = 0.0
    while True:
        now = time.time() - t_start
        if now > seconds:
            break
        if faults is not None and faults.next_t() <= now:
            # commit the in-flight async tick before the fleet mutates:
            # fault handling (crash re-submission, drain) must see fully
            # committed slot state, not one tick of lagged bookkeeping
            flush = getattr(engine, "flush_pending", None)
            if flush is not None:
                flush(now)
            for ev in faults.apply_due(now, engine):
                if log is not None:
                    log(f"  t={now:5.1f}s FAULT {ev.kind} {ev.target}")
        if now >= next_ctrl:
            ctrl.monitor.advance_to(now)
            d = ctrl.step(now, engine)
            if log is not None:
                active = {k: v for k, v in d.allocation.units.items() if v}
                log(f"  t={now:5.1f}s predicted={d.predicted_load:5.1f} rps "
                    f"backlog={engine.backlog(now):3.0f} -> {active}")
            next_ctrl += interval
        lam = load_fn(now)
        for _ in range(rng.poisson(lam * max(now - last, 1e-3))):
            ctrl.monitor.record(now, 1)
            engine.submit(
                Request(rid=rid,
                        tokens=rng.integers(0, vocab, prompt_len).astype(np.int64),
                        max_new=max_new, arrival=clk(), slo_ms=slo_ms),
                ctrl.dispatcher.next_backend())
            rid += 1
        last = now
        engine.step(now)   # one engine tick: admit into free slots + decode
        # the burn-rate check runs AFTER the tick's commit phase (with
        # async_tick, step() commits the previous tick's completions before
        # returning), so mid-interval alerts only ever see fully-committed
        # windows — never a tick of half-applied completions
        if slo_monitor is not None:
            fired = slo_monitor.check(now)
            if fired:
                if log is not None:
                    for a in fired:
                        log(f"  t={now:5.1f}s BURN slo_class={a.slo_class} "
                            f"fast={a.burn_fast:.1f}x slow={a.burn_slow:.1f}x")
                ctrl.monitor.advance_to(now)
                d = ctrl.maybe_react(now, engine)
                if d is not None and log is not None:
                    active = {k: v for k, v in d.allocation.units.items() if v}
                    log(f"  t={now:5.1f}s re-solve (burn_rate) -> {active}")
            flight = getattr(engine, "obs", None)
            flight = flight.flight if flight is not None else None
            if flight is not None:
                flight.snap_metrics(now, engine.obs.metrics)
        time.sleep(tick_sleep)
    engine.drain(seconds)  # finish whatever is still queued/in flight
    # Close the audit loop: bucket realized latencies/goodput back onto the
    # controller decisions that governed them (predicted vs measured).
    attach_from_requests(getattr(ctrl, "audit", None),
                         getattr(engine, "done", ()),
                         default_slo_ms=slo_ms)
    return rid


def rise_fall_load(seconds: float, lo: float = 4.0, hi: float = 32.0,
                   ) -> Callable[[float], float]:
    """The drivers' synthetic λ(t): a sin²-shaped ramp up then down."""
    def load(now: float) -> float:
        return lo + (hi - lo) * float(np.sin(np.pi * now / seconds) ** 2)
    return load
