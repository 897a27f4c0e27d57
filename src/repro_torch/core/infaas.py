"""INFaaS-style baseline (Romero et al., ATC '21) — the remaining row of the
paper's Table 1.

INFaaS is "model-less": each request (class) declares requirements and the
system picks, per request, the cheapest loaded variant meeting them, scaling
variants up/down reactively as load shifts. Key behavioural contrasts the
paper's Table 1 encodes:

  * cost-aware ✓ (cheapest variant meeting the latency requirement)
  * accuracy-maximizing ✗ (accuracy is a constraint, not an objective —
    INFaaS stops at "meets the requirement")
  * reactive, not predictive ✗ (scales on observed load)

Our controller: given a per-request latency requirement (the SLO) and a
minimum-accuracy requirement, pick the CHEAPEST variant satisfying both,
sized reactively for the observed peak; spillover to the next-cheapest
variant when the budget caps the primary (INFaaS's variant-autoscaling).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core.adapter import ControllerConfig, Decision
from repro_torch.core.dispatcher import WeightedRoundRobinDispatcher
from repro_torch.core.monitoring import RateMonitor
from repro_torch.core.objective import evaluate
from repro_torch.core.profiles import VariantProfile


class INFaaSController:
    """Model-less reactive baseline."""

    def __init__(self, profiles: Mapping[str, VariantProfile],
                 cfg: ControllerConfig, min_accuracy: float = 0.0,
                 peak_window_s: int = 60, headroom: float = 1.1):
        self.profiles = dict(profiles)
        self.cfg = cfg
        self.min_accuracy = min_accuracy
        self.peak_window_s = peak_window_s
        self.headroom = headroom
        self.monitor = RateMonitor()
        self.dispatcher = WeightedRoundRobinDispatcher()
        self.decisions: List[Decision] = []

    def _eligible(self) -> List[str]:
        """Variants meeting the accuracy requirement, cheapest-first
        (cost-per-RPS ascending)."""
        ok = [m for m, p in self.profiles.items()
              if p.accuracy >= self.min_accuracy
              and p.min_feasible_units(self.cfg.slo_ms) is not None]
        return sorted(ok, key=lambda m: 1.0 / max(self.profiles[m].th_slope, 1e-9))

    def step(self, t: float, cluster) -> Decision:
        peak = self.monitor.history(self.peak_window_s)
        lam = max(float(peak.max()) if len(peak) else 0.0, self.cfg.min_load)
        lam *= self.headroom
        units: Dict[str, int] = {}
        remaining, budget_left = lam, self.cfg.budget
        for m in self._eligible():
            if remaining <= 0 or budget_left <= 0:
                break
            p = self.profiles[m]
            lo = p.min_feasible_units(self.cfg.slo_ms)
            n = lo
            while n < min(p.max_units, budget_left) and p.throughput(n) < remaining:
                n += 1
            n = min(n, budget_left)
            units[m] = n
            remaining -= p.throughput(n)
            budget_left -= n
        cluster.apply_allocation(t, units)
        alloc = evaluate(self.profiles, units, lam, self.cfg.slo_ms,
                         alpha=self.cfg.alpha, beta=self.cfg.beta,
                         gamma=self.cfg.gamma,
                         loaded=cluster.loaded_variants(t))
        if alloc.quotas:
            self.dispatcher.set_weights(alloc.quotas)
        d = Decision(t=t, predicted_load=lam, allocation=alloc)
        self.decisions.append(d)
        return d
