"""Offline engine profiler — the paper's Profiler (§5), made real.

The paper profiles every variant at a handful of allocations
(``PROFILE_CORE_POINTS``) and regression-fits ``th_m(n) = a·n + b`` and
``p_m(n) = base + k/n`` from *measurements*. This module does exactly that
against the port's ``InProcessServingEngine`` (a port of the reference
package's ``repro.profiling.measure``):

  * an allocation of ``n`` units maps to an engine **concurrency cap** of
    ``n`` slots (points beyond ``max_batch`` are unmeasurable on a backend
    and are skipped, not extrapolated into the fit);
  * each point is measured under **saturating open-loop load**: the
    profiler keeps exactly ``n`` requests in flight at all times, so the
    completion rate *is* the saturation throughput at that allocation;
  * processing latency is taken from the queue-wait / service-time split
    (``Request.service_ms`` — prefill + decode, *excluding* admission-queue
    wait), which is what the paper's p_m(n) means;
  * readiness time rt_m is the backend's actually measured load
    (``VariantBackend.readiness_s``: init, one warm-up of every step and,
    on a card, the capture of its CUDA graph), not an assumed constant.

On a card every completion is stamped after the host has read the tokens
back (``commit_exec`` waits on their event; a request whose budget ends at
prefill is stamped after the first token's host copy), so the device time
is inside ``service_ms``.

Profile a sync, non-speculative engine, as the reference's example does: a
speculative verifier's throwaway backend would attach its drafter, and an
async engine's would build the continuation machinery. The profiler drives
the backend through the sync ``admit`` and ``decode_step_batch``.

One deliberate difference from the reference: a throwaway backend is
closed (``VariantBackend.close``) after its sweep, so its captured graphs
and their memory pool go at once rather than whenever the collector finds
them; a live backend is never closed.

The emitted ``VariantProfile`` carries the regression fit (R² as the
confidence signal) and slots straight into the Eq. 1 solver; the
``ProfileMeasurement`` wrapper keeps the raw points for the profile store.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import (PROFILE_CORE_POINTS, LinearRegressionFit,
                                 VariantProfile, fit_throughput)
from repro_torch.serving.api import Request


@dataclass
class MeasuredPoint:
    """One profiled allocation point (paper §5 measures five of these)."""
    units: int                  # allocation = engine concurrency cap
    throughput_rps: float       # saturation completion rate
    mean_service_ms: float      # processing latency p(n), queue wait excluded
    p99_service_ms: float
    mean_queue_ms: float        # ≈0 under the profiler's direct admission
    n_requests: int


@dataclass
class ProfileMeasurement:
    """A full measured profile: raw points + fits + the resulting profile.

    ``lat_base_ms``/``lat_k_ms`` fit the per-point **P99** service time —
    the semantics every consumer of ``VariantProfile.p99_ms`` assumes (the
    solver's SLO feasibility gate, ``min_feasible_units``). The parallel
    **mean**-service model (``lat_mean_*``) is what the drift detector
    compares live mean observations against; it travels in store meta."""
    name: str
    points: List[MeasuredPoint]
    th_fit: LinearRegressionFit
    lat_base_ms: float            # p99-service fit
    lat_k_ms: float
    lat_r_squared: float
    lat_mean_base_ms: float       # mean-service fit (drift reference)
    lat_mean_k_ms: float
    readiness_s: float
    profile: VariantProfile

    @property
    def confidence(self) -> float:
        """Joint fit confidence in [0, 1]: the weaker of the two R²s."""
        return float(np.clip(min(self.th_fit.r_squared, self.lat_r_squared),
                             0.0, 1.0))

    def store_meta(self) -> dict:
        """The standard meta block a ``ProfileStore`` entry carries for a
        measured profile (consumed by ``DriftDetector``)."""
        return {"lat_r_squared": self.lat_r_squared,
                "confidence": self.confidence,
                "mean_latency_model": [self.lat_mean_base_ms,
                                       self.lat_mean_k_ms],
                "points": [[p.units, p.throughput_rps, p.mean_service_ms]
                           for p in self.points]}


def fit_latency(points: Sequence[Tuple[int, float]]
                ) -> Tuple[float, float, float]:
    """Least-squares fit of the paper's latency model p(n) = base + k/n.

    Returns (base_ms, k_ms, r_squared). Engines whose service time is flat
    in n (chunked decode: batch-wide step cost) yield k ≈ 0; a negative k
    (latency *rising* with allocation — measurement noise) degenerates to
    the constant model, for which R² is reported as 1 when the data really
    is constant."""
    ns = np.array([p[0] for p in points], float)
    lat = np.array([p[1] for p in points], float)
    if len(ns) >= 2:
        A = np.stack([np.ones_like(ns), 1.0 / ns], axis=1)
        (base, k), *_ = np.linalg.lstsq(A, lat, rcond=None)
    else:
        base, k = float(lat.mean()), 0.0
    if k < 0.0:
        base, k = float(lat.mean()), 0.0
    base = max(float(base), 0.0)
    pred = base + k / ns
    ss_res = float(np.sum((lat - pred) ** 2))
    ss_tot = float(np.sum((lat - np.mean(lat)) ** 2))
    if ss_tot <= 1e-9 * max(1.0, float(np.mean(lat)) ** 2):
        r2 = 1.0          # constant data, constant model: perfect fit
    else:
        # clamping base/k above can leave the model worse than the mean;
        # floor at 0 so R² stays a valid [0, 1] confidence signal
        r2 = max(1.0 - ss_res / ss_tot, 0.0)
    return base, float(k), float(r2)


class EngineProfiler:
    """Sweeps ``InProcessServingEngine`` variants across allocation points.

    Drives each ``VariantBackend`` directly (admission + decode chunks),
    bypassing the engine queues so profiling traffic never pollutes
    ``engine.done`` metrics. A variant already loaded on the engine is
    profiled in place (its in-flight work is drained to ``engine.done``
    first); an unloaded one gets a throwaway backend, closed after its
    sweep — so targeted re-profiling between control intervals never
    retires live variants.
    """

    def __init__(self, engine, *, points: Sequence[int] = PROFILE_CORE_POINTS,
                 requests_per_point: int = 24, warmup: int = 4,
                 vocab: int = 128, max_units: int = 64, seed: int = 0):
        self.engine = engine
        self.points = tuple(points)
        self.requests_per_point = requests_per_point
        self.warmup = warmup
        self.vocab = vocab
        self.max_units = max_units
        self.seed = seed

    # ------------------------------------------------------------- backends
    def _backend(self, name: str):
        """(backend, throwaway?) for ``name``."""
        eng = self.engine
        if name in eng.backends:
            b = eng.backends[name]
            eng.done.extend(b.drain_slots(time.time()))  # free all slots
            return b, False
        # throwaway backend built by the engine's own factory, so it carries
        # the engine's KV discipline (dense ring vs paged pool) — a paged
        # engine must be profiled under paged admission/decode semantics or
        # the fitted th(n)/p(n) describe a backend it never runs
        return eng._make_backend(name), True

    # ----------------------------------------------------------- measurement
    def _measure_point(self, b, cap: int, rpp: int) -> MeasuredPoint:
        """Saturating open-loop measurement at concurrency ``cap``: keep
        exactly ``cap`` requests in flight; after the warm-up quota, time
        at least ``rpp`` further completions.

        Completions retire in lock-step batches (equal token budgets, joint
        admission), so the warm-up quota is consumed in *whole batches* —
        counting the tail of a partially-warm batch as measured would stamp
        ``t_meas0`` mid-batch and inflate throughput by up to a batch's
        worth of near-zero elapsed time."""
        rng = np.random.default_rng(self.seed + 7919 * cap)
        rid = 0
        warm_left = self.warmup
        measured: List[Request] = []
        t_meas0: Optional[float] = time.time() if warm_left == 0 else None
        # arrivals must come from the SAME clock the backend stamps
        # service_start/completion with (the engine's injectable clock may
        # be an elapsed-seconds domain) — mixing domains corrupts the
        # queue-wait split this profiler fits p(n) from
        clk = getattr(b, "clock", time.time)

        def new_request() -> Request:
            nonlocal rid
            r = Request(rid=rid,
                        tokens=rng.integers(0, self.vocab,
                                            b.prompt_len).astype(np.int64),
                        max_new=b.max_new, arrival=clk())
            rid += 1
            return r

        while len(measured) < rpp:
            now = time.time()
            want = cap - b.active_slots
            done = b.admit([new_request() for _ in range(want)], now) \
                if want > 0 else []
            done += b.decode_step_batch(time.time())
            if not done:
                continue
            if warm_left > 0:
                warm_left -= len(done)       # whole batch is warm-up
                if warm_left <= 0:
                    t_meas0 = time.time()
                continue
            measured.extend(done)
        elapsed = max(time.time() - t_meas0, 1e-9)
        b.drain_slots(time.time())        # discard in-flight leftovers
        svc = np.array([r.service_ms for r in measured])
        que = np.array([r.queue_wait_ms for r in measured])
        return MeasuredPoint(
            units=cap, throughput_rps=len(measured) / elapsed,
            mean_service_ms=float(svc.mean()),
            p99_service_ms=float(np.percentile(svc, 99)),
            mean_queue_ms=float(que.mean()), n_requests=len(measured))

    def profile_variant(self, name: str, *,
                        points: Optional[Sequence[int]] = None,
                        requests_per_point: Optional[int] = None
                        ) -> ProfileMeasurement:
        """Measure one variant across the allocation sweep and fit profiles."""
        b, throwaway = self._backend(name)
        rpp = requests_per_point or self.requests_per_point
        usable = sorted({p for p in (points or self.points)
                         if 1 <= p <= b.max_batch})
        if not usable:
            usable = [b.max_batch]
        # the sweep sets its own concurrency per point — suspend any
        # enforce_units cap on a live backend for the measurement
        saved_cap, b.slot_cap = b.slot_cap, None
        try:
            m_points = [self._measure_point(b, cap, rpp) for cap in usable]
        finally:
            b.slot_cap = saved_cap
            if throwaway:       # its graphs and their pool go now
                b.close()

        th_pts = [(p.units, p.throughput_rps) for p in m_points]
        if len(th_pts) >= 2:
            th_fit = fit_throughput(th_pts)
        else:   # single measurable point: capacity line through the origin
            (n0, th0), = th_pts
            th_fit = LinearRegressionFit(th0 / n0, 0.0, 1.0, list(th_pts))
        # profile latency = p99-service fit (what p99_ms consumers assume);
        # the mean-service fit rides along for the drift detector
        lat_base, lat_k, lat_r2 = fit_latency(
            [(p.units, p.p99_service_ms) for p in m_points])
        mean_base, mean_k, _ = fit_latency(
            [(p.units, p.mean_service_ms) for p in m_points])
        profile = VariantProfile(
            name=name, accuracy=b.accuracy, rt=b.readiness_s,
            th_slope=th_fit.slope, th_intercept=th_fit.intercept,
            lat_base_ms=lat_base, lat_k_ms=lat_k, max_units=self.max_units)
        return ProfileMeasurement(
            name=name, points=m_points, th_fit=th_fit, lat_base_ms=lat_base,
            lat_k_ms=lat_k, lat_r_squared=lat_r2,
            lat_mean_base_ms=mean_base, lat_mean_k_ms=mean_k,
            readiness_s=b.readiness_s, profile=profile)

    def profile_all(self, store=None) -> Dict[str, ProfileMeasurement]:
        """Sweep every variant the engine knows; optionally register each
        result in a ``ProfileStore`` under provenance ``"measured"``."""
        out = {}
        for name in sorted(self.engine.variant_defs):
            m = self.profile_variant(name)
            out[name] = m
            if store is not None:
                store.register(m.profile, "measured", fit=m.th_fit,
                               meta=m.store_meta())
        return out
