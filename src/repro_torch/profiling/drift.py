"""Online profile-drift detection and targeted recalibration.

A stored profile is a *claim* about the engine: serve at allocation n and
processing latency will be ≈ p(n), capacity ≈ th(n). Engines drift — a
changed decode chunk, CPU contention, a different kernel path — and a
controller solving Eq. 1 against stale claims provisions wrongly (Loki,
arXiv 2407.03583, makes the same observation for GPU pipelines).

``DriftDetector`` folds completed requests (their measured queue/service
split) into per-variant sliding windows and compares, per variant:

  * observed mean service time  vs  the profile's mean-service model
    (stored in meta by measured profiles; falls back to the p99 curve,
    conservatively, when absent) at the current allocation — ratio outside
    the tolerance band ``[1/(1+tol), 1+tol]`` flags drift in either
    direction. Service time is load-independent, so this is the primary
    signal.
  * observed completion rate    vs  profiled capacity th(n) — reported in
    every ``DriftReport``; it *flags* drift only when ``throughput_band``
    is set AND the observation runs over capacity (below capacity is the
    normal partial-load regime, not evidence the profile is wrong).
    Capacity comparisons only mean anything when the engine enforces the
    units -> concurrency mapping the profiles were measured under
    (``InProcessServingEngine(enforce_units=True)``), hence opt-in.

``OnlineRecalibrator`` acts on a flagged variant between control
intervals: a quick targeted re-profile of that single variant (the
``EngineProfiler`` with a reduced sweep), the store patched under
provenance ``"measured"``, and the live controller's profile swapped via
``InfAdapterController.update_profiles`` — the next solve allocates
against reality.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

DEFAULT_TOLERANCE = 0.35          # ±35% band before a profile counts as stale


@dataclass
class DriftReport:
    """Verdict for one variant at one check."""
    variant: str
    drifted: bool
    service_ratio: float          # observed mean service / profiled p(n)
    throughput_ratio: float       # observed rate / profiled th(n) (0 if idle)
    n_obs: int
    reason: str = ""


class _VariantWindow:
    """Sliding window of completions for one variant."""

    def __init__(self, window: int):
        self.service_ms: Deque[float] = deque(maxlen=window)
        self.completions: Deque[float] = deque(maxlen=window)

    def add(self, service_ms: float, completion_t: float) -> None:
        self.service_ms.append(service_ms)
        self.completions.append(completion_t)

    def observed_rate(self) -> float:
        """Completion rate over the window's wall-clock span (0 if <2 obs)."""
        if len(self.completions) < 2:
            return 0.0
        span = max(self.completions[-1] - self.completions[0], 1e-9)
        return (len(self.completions) - 1) / span


class DriftDetector:
    """Compares live observations against stored profiles.

    ``profiles`` may be a ``ProfileStore`` or a plain name -> profile
    mapping (anything with ``profiles()`` or dict semantics)."""

    def __init__(self, profiles, *, tolerance: float = DEFAULT_TOLERANCE,
                 min_requests: int = 10, window: int = 256,
                 throughput_band: Optional[float] = None):
        self._source = profiles
        self.tolerance = tolerance
        self.min_requests = min_requests
        self.window = window
        self.throughput_band = throughput_band
        self._stats: Dict[str, _VariantWindow] = {}
        self._consumed = 0        # engine.done cursor for observe_engine

    def _profiles(self) -> Mapping:
        if hasattr(self._source, "profiles"):
            return self._source.profiles()
        return self._source

    def _meta(self, name: str) -> Optional[Dict]:
        """Store meta for ``name`` when the source is a ProfileStore."""
        if hasattr(self._source, "entry") and name in self._source:
            return self._source.entry(name).meta
        return None

    # ---------------------------------------------------------- observations
    def observe(self, req) -> None:
        """Fold one completed request (needs ``backend``, ``service_ms``,
        ``completion``) into its variant's window."""
        if not req.backend:
            return
        w = self._stats.setdefault(req.backend, _VariantWindow(self.window))
        w.add(req.service_ms, req.completion)

    def observe_engine(self, engine) -> int:
        """Consume completions appended to ``engine.done`` since last call."""
        new = engine.done[self._consumed:]
        self._consumed = len(engine.done)
        for r in new:
            self.observe(r)
        return len(new)

    def reset(self, name: str) -> None:
        """Forget a variant's window (after recalibration: the old
        observations described the profile we just replaced)."""
        self._stats.pop(name, None)

    # ---------------------------------------------------------------- checks
    def check(self, name: str, units: int = 1) -> DriftReport:
        profiles = self._profiles()
        if name not in profiles:
            return DriftReport(name, False, 0.0, 0.0, 0, "no profile")
        w = self._stats.get(name)
        n_obs = len(w.service_ms) if w else 0
        if n_obs < self.min_requests:
            return DriftReport(name, False, 0.0, 0.0, n_obs,
                               f"insufficient observations ({n_obs})")
        p = profiles[name]
        # compare observed MEAN service against the profile's mean-service
        # model (store meta, measured profiles); fall back to the p99 curve
        # when no mean model exists — conservative: mean/p99 < 1, so only
        # large slowdowns cross the upper band
        meta = self._meta(name)
        model = (meta or {}).get("mean_latency_model")
        if model:
            predicted_ms = max(model[0] + model[1] / max(units, 1), 1e-9)
        else:
            predicted_ms = max(p.p99_ms(units), 1e-9)
        observed_ms = float(np.mean(w.service_ms))
        service_ratio = observed_ms / predicted_ms
        cap = max(p.throughput(units), 1e-9)
        throughput_ratio = w.observed_rate() / cap
        hi, lo = 1.0 + self.tolerance, 1.0 / (1.0 + self.tolerance)
        reasons = []
        if service_ratio > hi:
            reasons.append(f"service {service_ratio:.2f}x slower than p({units})")
        elif service_ratio < lo:
            reasons.append(f"service {service_ratio:.2f}x of p({units}) — "
                           "profile pessimistic")
        if (self.throughput_band is not None
                and throughput_ratio > 1.0 + self.throughput_band):
            reasons.append(f"throughput {throughput_ratio:.2f}x profiled "
                           f"capacity th({units})")
        return DriftReport(name, bool(reasons), service_ratio,
                           throughput_ratio, n_obs, "; ".join(reasons))

    def check_all(self, units: Mapping[str, int]) -> List[DriftReport]:
        return [self.check(m, n) for m, n in sorted(units.items()) if n > 0]


class OnlineRecalibrator:
    """Targeted re-profiling of drifted variants between control intervals.

    Wires detector -> profiler -> store -> controller: one quick sweep of
    only the flagged variant, the store patched (provenance stays
    ``"measured"``, recalibration history in meta), the live controller's
    profile table updated in place."""

    def __init__(self, profiler, store, *, controller=None, detector=None,
                 points: Tuple[int, ...] = (1, 2, 4),
                 requests_per_point: int = 8):
        self.profiler = profiler
        self.store = store
        self.controller = controller
        self.detector = detector
        self.points = points
        self.requests_per_point = requests_per_point
        self.recalibrations: List[Tuple[float, str]] = []

    def recalibrate(self, name: str):
        """Re-measure one variant and propagate the fresh profile."""
        m = self.profiler.profile_variant(
            name, points=self.points,
            requests_per_point=self.requests_per_point)
        prev = self.store.entry(name).updated_at if name in self.store else None
        self.store.register(
            m.profile, "measured", fit=m.th_fit,
            meta={**m.store_meta(), "recalibrated": True,
                  "previous_updated_at": prev})
        if self.controller is not None:
            self.controller.update_profiles({name: m.profile})
        if self.detector is not None:
            self.detector.reset(name)
        self.recalibrations.append((time.time(), name))
        return m

    def run_check(self, units: Mapping[str, int]) -> List[DriftReport]:
        """Check every allocated variant; recalibrate the drifted ones.
        Returns the reports (recalibrated variants have ``drifted=True``)."""
        if self.detector is None:
            return []
        reports = self.detector.check_all(units)
        for rep in reports:
            if rep.drifted:
                self.recalibrate(rep.variant)
        return reports
