"""Equation 1 of the paper: objective terms + optimal quota assignment.

    max  α·AA − (β·RC + γ·LC)
    s.t. λ ≤ Σ th_m(n_m);  λ_m ≤ th_m(n_m);  p_m(n_m) ≤ L;  Σ n_m ≤ B

AA is the traffic-weighted average accuracy. For a *fixed* allocation the
quota assignment maximizing AA is the accuracy-descending water-fill (send as
much traffic as possible to the most accurate variant first) — provably
optimal because accuracies are constants and capacity is interchangeable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Set

from repro_torch.core.profiles import VariantProfile


@dataclass
class Allocation:
    """Solver output: per-variant resource units + traffic quotas."""
    units: Dict[str, int] = field(default_factory=dict)
    quotas: Dict[str, float] = field(default_factory=dict)
    objective: float = float("-inf")
    aa: float = 0.0
    rc: float = 0.0
    lc: float = 0.0
    feasible: bool = False
    served: float = 0.0            # RPS coverable (= min(λ, Σ th))
    predicted_load: float = 0.0

    def total_units(self) -> int:
        return sum(self.units.values())

    def active_variants(self) -> Set[str]:
        return {m for m, n in self.units.items() if n > 0}


def assign_quotas(profiles: Mapping[str, VariantProfile],
                  units: Mapping[str, int], lam: float) -> Dict[str, float]:
    """Accuracy-descending water-fill of λ over variant capacities."""
    order = sorted((m for m, n in units.items() if n > 0),
                   key=lambda m: -profiles[m].accuracy)
    remaining = lam
    quotas: Dict[str, float] = {}
    for m in order:
        cap = profiles[m].throughput(units[m])
        q = min(cap, remaining)
        quotas[m] = q
        remaining -= q
    return quotas


def loading_cost(profiles: Mapping[str, VariantProfile],
                 selected: Iterable[str], loaded: Set[str]) -> float:
    """LC = max{tc_m · rt_m}: readiness time of the slowest cold-started
    variant (0 when every selected variant is already resident)."""
    cold = [profiles[m].rt for m in selected if m not in loaded]
    return max(cold) if cold else 0.0


def evaluate(profiles: Mapping[str, VariantProfile], units: Mapping[str, int],
             lam: float, slo_ms: float, *, alpha: float = 1.0,
             beta: float = 0.05, gamma: float = 0.01,
             loaded: Optional[Set[str]] = None) -> Allocation:
    """Score an allocation under Eq. 1 (quotas water-filled)."""
    loaded = loaded or set()
    active = {m: n for m, n in units.items() if n > 0}
    # latency SLO feasibility per variant
    for m, n in active.items():
        if profiles[m].p99_ms(n) > slo_ms:
            return Allocation(units=dict(units), feasible=False,
                              predicted_load=lam)
    cap = sum(profiles[m].throughput(n) for m, n in active.items())
    quotas = assign_quotas(profiles, active, lam)
    served = sum(quotas.values())
    aa = (sum(quotas[m] * profiles[m].accuracy for m in quotas) / lam
          if lam > 0 else 0.0)
    rc = float(sum(active.values()))
    lc = loading_cost(profiles, active, loaded)
    obj = alpha * aa - (beta * rc + gamma * lc)
    return Allocation(units=dict(units), quotas=quotas, objective=obj, aa=aa,
                      rc=rc, lc=lc, feasible=cap + 1e-9 >= lam, served=served,
                      predicted_load=lam)
