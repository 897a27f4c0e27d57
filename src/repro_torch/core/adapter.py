"""The InfAdapter control loop + the VPA+/MS+ baseline controllers.

Every ``interval_s`` (paper: 30 s) the adapter:
  1. reads per-second load history from the monitor,
  2. forecasts the next-minute max load,
  3. solves Eq. 1 for a variant set + allocations + quotas,
  4. enacts the config on the cluster (new variants become ready after their
     readiness time rt_m — the zero-downtime create-then-remove semantics the
     paper patched into VPA is the default here),
  5. pushes quotas to the dispatcher.

The cluster is abstract — the shared ``ClusterAPI`` protocol lives in
``repro.serving.api``; the discrete-event simulator (``SimCluster``) and the
real serving engine (``InProcessServingEngine``) both implement it, so
every controller in this module drives either backend unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Set

import numpy as np

from repro_torch.core.dispatcher import WeightedRoundRobinDispatcher
from repro_torch.core.monitoring import RateMonitor
from repro_torch.core.objective import Allocation, evaluate
from repro_torch.core.profiles import VariantProfile
from repro_torch.core.solver import SOLVERS
from repro_torch.obs.audit import DecisionAudit, predict_outputs
from repro_torch.obs.slo import CollectingSink
from repro_torch.serving.api import ClusterAPI  # noqa: F401  (re-export: public API)


@dataclass
class ControllerConfig:
    interval_s: float = 30.0
    budget: int = 20
    slo_ms: float = 750.0
    alpha: float = 1.0
    beta: float = 0.05
    gamma: float = 0.01
    solver: str = "exact"
    min_load: float = 1.0          # floor for the predicted load
    # --- beyond-paper extensions (off by default = paper-faithful) ---
    reactive: bool = False         # emergency re-solve when observed load
    reactive_check_s: float = 5.0  # exceeds provisioned capacity
    queue_aware: bool = False      # inflate λ by backlog/interval to drain


@dataclass
class Decision:
    t: float
    predicted_load: float
    allocation: Allocation


class InfAdapterController:
    """The paper's Adapter component (forecaster + solver)."""

    def __init__(self, profiles: Mapping[str, VariantProfile],
                 forecaster, cfg: ControllerConfig,
                 dispatcher: Optional[WeightedRoundRobinDispatcher] = None,
                 audit: Optional[DecisionAudit] = None,
                 burn_alerts: Optional[CollectingSink] = None):
        self.profiles = dict(profiles)
        self.forecaster = forecaster
        self.cfg = cfg
        self.dispatcher = dispatcher or WeightedRoundRobinDispatcher()
        self.monitor = RateMonitor()
        self.decisions: List[Decision] = []
        self.audit = audit if audit is not None else DecisionAudit()
        self.burn_alerts = burn_alerts
        self._decide_reason = "interval"

    def update_profiles(self, updates: Mapping[str, VariantProfile]) -> None:
        """Online recalibration hook (``repro.profiling.drift``): swap in
        re-measured profiles between control intervals. The next ``decide``
        solves Eq. 1 against the refreshed th_m(n)/p_m(n) curves — the paper
        treats profiles as static inputs; keeping them honest against the
        live engine is the drift-recalibration extension."""
        self.profiles.update(updates)

    def predict(self) -> float:
        """Next-interval peak load λ̂ (requests/s) from the last 10 min of
        per-second history — the paper's LSTM forecaster input window (§4.1,
        Fig. 5 top); floored at ``min_load`` so Eq. 1 always has demand."""
        recent = self.monitor.history(600)
        lam = self.forecaster.predict(recent)
        return max(lam, self.cfg.min_load)

    def decide(self, t: float, cluster: ClusterAPI) -> Decision:
        """One planning pass (no actuation): forecast λ for the next interval
        (paper §4.1) and solve Eq. 1 — maximize α·AA − β·RC − γ·LC subject to
        the latency SLO and budget — seeding LC with the cluster's currently
        loaded variants."""
        lam_forecast = self.predict()
        lam = lam_forecast
        backlog = cluster.backlog(t)
        if self.cfg.queue_aware:
            lam += backlog / self.cfg.interval_s  # drain in one interval
        loaded = cluster.loaded_variants(t)
        solver = SOLVERS[self.cfg.solver]
        alloc = solver(self.profiles, lam, self.cfg.budget, self.cfg.slo_ms,
                       alpha=self.cfg.alpha, beta=self.cfg.beta,
                       gamma=self.cfg.gamma, loaded=loaded)
        d = Decision(t=t, predicted_load=lam, allocation=alloc)
        self.decisions.append(d)
        self._audit(t, cluster, lam_forecast, lam, backlog, loaded, alloc)
        return d

    def _audit(self, t: float, cluster: ClusterAPI, lam_forecast: float,
               lam: float, backlog: float, loaded: Set[str],
               alloc: Allocation) -> None:
        """Append this adaptation's inputs/outputs to the decision audit
        log (``repro.obs.audit``), including the profile-implied predicted
        p99/goodput so post-run ``attach_measured`` can compute regret."""
        cap_fn = getattr(cluster, "capacity_factor", None)
        inputs = {
            "lam_forecast": float(lam_forecast),
            "lam": float(lam),
            "backlog": float(backlog),
            "capacity_factor": (float(cap_fn(t)) if cap_fn is not None
                                else 1.0),
            "loaded": sorted(loaded),
            "solver": self.cfg.solver,
            "budget": self.cfg.budget,
            "slo_ms": self.cfg.slo_ms,
        }
        outputs = {
            "units": dict(alloc.units),
            "quotas": {m: float(q) for m, q in alloc.quotas.items()},
            "objective": float(alloc.objective),
            "aa": float(alloc.aa), "rc": float(alloc.rc),
            "lc": float(alloc.lc), "feasible": bool(alloc.feasible),
            "predicted": predict_outputs(self.profiles, alloc, lam,
                                         self.cfg.slo_ms),
        }
        reason, self._decide_reason = self._decide_reason, "interval"
        self.audit.record(t, type(self).__name__, inputs, outputs,
                          reason=reason)

    def step(self, t: float, cluster: ClusterAPI) -> Decision:
        """One full control iteration (paper Fig. 3, every ``interval_s``):
        decide, enact on the cluster (create-then-remove reconfiguration),
        and push the solver's per-variant quotas λ_m to the dispatcher."""
        d = self.decide(t, cluster)
        cluster.apply_allocation(t, d.allocation.units)
        if d.allocation.quotas:
            self.dispatcher.set_weights(d.allocation.quotas)
        return d

    def maybe_react(self, t: float, cluster: ClusterAPI) -> Optional[Decision]:
        """Beyond-paper: between intervals, if the observed short-window rate
        exceeds the last decision's provisioned capacity, re-solve immediately
        (MArk-style reactive scaling on top of the proactive loop).

        Replica-fabric clusters report ``capacity_factor`` — the fraction of
        the target allocation actually live (node crashes, placement
        shortfall). Provisioned capacity is discounted by it, so losing a
        node triggers a re-solve (and thereby re-placement) at the next
        reactive check instead of waiting out the control interval.

        A ``burn_alerts`` sink (``repro_torch.obs.slo.CollectingSink`` fed by
        an ``SLOMonitor``) adds a second trigger: any pending burn-rate alert
        forces an immediate re-solve, independent of ``cfg.reactive`` —
        the SLO is already burning, so capacity-vs-rate arithmetic is moot.
        This is the first consumer of the goodput-aware-control roadmap
        item: the control loop reacts to *measured* SLO attainment, not
        just offered load."""
        if self.burn_alerts is not None and self.decisions:
            fired = self.burn_alerts.pop_pending()
            if fired:
                self._decide_reason = "burn_rate"
                return self.step(t, cluster)
        if not self.cfg.reactive or not self.decisions:
            return None
        last = self.decisions[-1].allocation
        cap = sum(self.profiles[m].throughput(n)
                  for m, n in last.units.items() if n > 0)
        cap_fn = getattr(cluster, "capacity_factor", None)
        if cap_fn is not None:
            cap *= cap_fn(t)
        observed = self.monitor.current_rate(window=5) * 1.1
        backlog = cluster.backlog(t)
        if observed > cap or backlog > cap * 2.0:
            self._decide_reason = "reactive"
            return self.step(t, cluster)
        return None


class MSPlusController(InfAdapterController):
    """Model-Switching+ (baseline): single variant + predictive sizing,
    same objective — the paper's MS extension."""

    def __init__(self, profiles, forecaster, cfg: ControllerConfig, **kw):
        cfg = ControllerConfig(**{**cfg.__dict__, "solver": "single"})
        super().__init__(profiles, forecaster, cfg, **kw)


class VPAPlusController:
    """Kubernetes VPA, as patched by the paper (VPA+): one *fixed* variant;
    the recommender tracks a usage percentile with headroom, scales up
    immediately, scales down conservatively (hysteresis). Zero-downtime
    create-then-remove is modeled by the cluster's readiness semantics.

    Resource recommendation follows Autopilot-style target utilization:
        n = ceil(cores needed for peak recent load / target_util)
    using the variant's own throughput profile.
    """

    def __init__(self, profile: VariantProfile, cfg: ControllerConfig,
                 target_util: float = 0.8, peak_window_s: int = 120,
                 downscale_patience: int = 4,
                 dispatcher: Optional[WeightedRoundRobinDispatcher] = None,
                 audit: Optional[DecisionAudit] = None):
        self.profile = profile
        self.cfg = cfg
        self.target_util = target_util
        self.peak_window_s = peak_window_s
        self.downscale_patience = downscale_patience
        self.dispatcher = dispatcher or WeightedRoundRobinDispatcher()
        self.monitor = RateMonitor()
        self.decisions: List[Decision] = []
        self.audit = audit if audit is not None else DecisionAudit()
        self._below_count = 0
        self._last_units = 0

    def _units_for(self, lam: float) -> int:
        p = self.profile
        need = lam / max(self.target_util, 1e-6)
        if p.th_slope <= 0:
            return self.cfg.budget
        n = int(np.ceil((need - p.th_intercept) / p.th_slope))
        lo = p.min_feasible_units(self.cfg.slo_ms) or 1
        return int(np.clip(n, lo, self.cfg.budget))

    def step(self, t: float, cluster: ClusterAPI) -> Decision:
        peak = self.monitor.history(self.peak_window_s)
        lam = float(peak.max()) if len(peak) else self.cfg.min_load
        lam = max(lam, self.cfg.min_load)
        n = self._units_for(lam)
        if n < self._last_units:
            # paper: dropped the lower bound to scale up faster; scale DOWN
            # keeps hysteresis so transient dips don't thrash
            self._below_count += 1
            if self._below_count < self.downscale_patience:
                n = self._last_units
            else:
                self._below_count = 0
        else:
            self._below_count = 0
        self._last_units = n
        units = {self.profile.name: n}
        cluster.apply_allocation(t, units)
        alloc = evaluate({self.profile.name: self.profile}, units, lam,
                         self.cfg.slo_ms, alpha=self.cfg.alpha,
                         beta=self.cfg.beta, gamma=self.cfg.gamma)
        self.dispatcher.set_weights({self.profile.name: 1.0})
        d = Decision(t=t, predicted_load=lam, allocation=alloc)
        self.decisions.append(d)
        profs = {self.profile.name: self.profile}
        self.audit.record(
            t, type(self).__name__,
            inputs={"lam": float(lam), "target_util": self.target_util,
                    "slo_ms": self.cfg.slo_ms, "budget": self.cfg.budget},
            outputs={"units": dict(units),
                     "predicted": predict_outputs(profs, alloc, lam,
                                                  self.cfg.slo_ms)})
        return d
