"""Cocktail-style ensembling baseline (Gunasekaran et al., NSDI '22).

The paper's Table 1 positions Cocktail as the closest related work but could
not compare against it ("due to fundamental structural differences"). We close
that gap with a faithful-in-spirit ensemble controller:

  * Cocktail serves each request through an ENSEMBLE of (cheaper) variants
    and majority-votes, reaching (or beating) the accuracy of the largest
    single model while autoscaling each ensemble member independently.
  * Cost model: every request runs on every ensemble member, so each member
    must individually sustain the full load λ — this is exactly the cost
    inefficiency the paper calls out ("all the requests should be sent to all
    the ML models").
  * Ensemble accuracy: majority vote of k independent-ish classifiers with
    per-model accuracy p_i. We use the standard independence upper bound with
    a correlation discount ρ (errors of sibling models correlate; ρ=0.6 by
    default, matching the 2-4% ensemble gains Cocktail reports rather than
    the unrealistic independence numbers).

The controller picks the ensemble (subset of variants, odd-sized) + sizes
that maximize the same Eq. 1 objective with AA replaced by ensemble accuracy.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Dict, List, Mapping, Optional, Set

import numpy as np

from repro_torch.core.adapter import ControllerConfig, Decision
from repro_torch.core.dispatcher import WeightedRoundRobinDispatcher
from repro_torch.core.monitoring import RateMonitor
from repro_torch.core.objective import Allocation
from repro_torch.core.profiles import VariantProfile


def majority_vote_accuracy(accs: List[float], rho: float = 0.6) -> float:
    """Majority-vote accuracy of an odd ensemble, correlation-discounted.

    Independence would give  P(majority correct) = sum over majorities;
    real sibling models correlate, so we interpolate between the best single
    model (ρ=1) and the independent ensemble (ρ=0).
    """
    k = len(accs)
    if k == 1:
        return accs[0]
    ps = np.array(accs, float) / 100.0
    # independent majority vote via DP over correct-count distribution
    dist = np.zeros(k + 1)
    dist[0] = 1.0
    for p in ps:
        dist = np.roll(dist, 1) * p + dist * (1 - p)
        # np.roll trick: new[j] = old[j-1]*p + old[j]*(1-p)
    indep = float(dist[(k // 2 + 1):].sum())
    best = float(ps.max())
    return 100.0 * (rho * best + (1 - rho) * indep)


def _min_units_for_load(p: VariantProfile, lam: float, budget: int,
                        slo_ms: float) -> Optional[int]:
    lo = p.min_feasible_units(slo_ms)
    if lo is None:
        return None
    for n in range(lo, budget + 1):
        if p.throughput(n) >= lam:
            return n
    return None


def solve_cocktail(profiles: Mapping[str, VariantProfile], lam: float,
                   budget: int, slo_ms: float, *, alpha: float = 1.0,
                   beta: float = 0.05, gamma: float = 0.01,
                   loaded: Optional[Set[str]] = None,
                   max_ensemble: int = 5, rho: float = 0.6) -> Allocation:
    """Best odd ensemble + per-member sizing under Eq. 1 semantics.

    Every member must sustain the FULL load λ (requests fan out to all)."""
    loaded = loaded or set()
    names = sorted(profiles)
    best = Allocation(predicted_load=lam)
    for k in (1, 3, max_ensemble):
        if k > len(names):
            continue
        for combo in combinations(names, k):
            units: Dict[str, int] = {}
            ok = True
            for m in combo:
                n = _min_units_for_load(profiles[m], lam, budget, slo_ms)
                if n is None:
                    ok = False
                    break
                units[m] = n
            if not ok or sum(units.values()) > budget:
                continue
            acc = majority_vote_accuracy([profiles[m].accuracy for m in combo],
                                         rho)
            rc = float(sum(units.values()))
            cold = [profiles[m].rt for m in combo if m not in loaded]
            lc = max(cold) if cold else 0.0
            obj = alpha * acc - beta * rc - gamma * lc
            if obj > best.objective or not best.feasible:
                best = Allocation(
                    units=units, quotas={m: lam for m in combo},
                    objective=obj, aa=acc, rc=rc, lc=lc, feasible=True,
                    served=lam, predicted_load=lam)
    return best


class CocktailController:
    """Ensembling autoscaler baseline. NOTE the dispatcher fans out: every
    request goes to EVERY ensemble member (the simulator models this by
    dispatching to each backend)."""

    def __init__(self, profiles: Mapping[str, VariantProfile], forecaster,
                 cfg: ControllerConfig, rho: float = 0.6):
        self.profiles = dict(profiles)
        self.forecaster = forecaster
        self.cfg = cfg
        self.rho = rho
        self.monitor = RateMonitor()
        self.dispatcher = WeightedRoundRobinDispatcher()
        self.decisions: List[Decision] = []
        self.current_ensemble: List[str] = []

    def step(self, t: float, cluster) -> Decision:
        lam = max(self.forecaster.predict(self.monitor.history(600)),
                  self.cfg.min_load)
        alloc = solve_cocktail(self.profiles, lam, self.cfg.budget,
                               self.cfg.slo_ms, alpha=self.cfg.alpha,
                               beta=self.cfg.beta, gamma=self.cfg.gamma,
                               loaded=cluster.loaded_variants(t), rho=self.rho)
        cluster.apply_allocation(t, alloc.units)
        self.current_ensemble = sorted(alloc.active_variants())
        # fan-out dispatch is handled by the runner via `fanout_backends`
        self.dispatcher.set_weights({m: 1.0 for m in self.current_ensemble}
                                    if self.current_ensemble else {})
        d = Decision(t=t, predicted_load=lam, allocation=alloc)
        self.decisions.append(d)
        return d

    def fanout_backends(self) -> List[str]:
        return list(self.current_ensemble)
