"""Solvers for the paper's ILP (Eq. 1).

The paper brute-forces the configuration space through Gurobi. We provide:

  * ``solve_exact``   — exact dynamic program over (variant, budget, unserved
    load) with the loading-cost ``max`` handled by enumerating its O(|M|)
    possible values. Polynomial where brute force is exponential — this is
    already a beyond-paper scalability contribution, answering the paper's
    own "Scalability with ML" future-work section with an exact method.
  * ``solve_bruteforce`` — literal enumeration (paper-faithful semantics);
    used as the ground truth in property tests at small scale.
  * ``solve_greedy``  — marginal-gain heuristic with local repair; scales to
    hundreds of variants (evaluated vs exact in benchmarks/solver_scalability).
  * ``solve_single_variant`` — the MS+ baseline restriction (|M'| = 1).

All solvers share the objective/quota machinery in ``objective.py``. Loads are
discretized to integer RPS in the DP (documented approximation; bruteforce
cross-check bounds the error in tests).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.objective import Allocation, evaluate, loading_cost
from repro_torch.core.profiles import VariantProfile


def _feasible_units(p: VariantProfile, slo_ms: float, budget: int) -> List[int]:
    """Unit counts (excluding 0) meeting the latency SLO within budget."""
    lo = p.min_feasible_units(slo_ms)
    if lo is None or lo > budget:
        return []
    return list(range(lo, min(budget, p.max_units) + 1))


def _best_effort(profiles: Mapping[str, VariantProfile], lam: float,
                 budget: int, slo_ms: float, **kw) -> Allocation:
    """When no config covers λ: maximize capacity (paper's under-provision
    regime — violations happen, serve as much as possible)."""
    best: Optional[Allocation] = None
    # greedy: put all budget on the highest-capacity-per-unit feasible variant,
    # then refine with the greedy solver seeded at max capacity.
    alloc = solve_greedy(profiles, lam, budget, slo_ms,
                         prefer_capacity=True, **kw)
    return alloc


def solve_bruteforce(profiles: Mapping[str, VariantProfile], lam: float,
                     budget: int, slo_ms: float, *, alpha: float = 1.0,
                     beta: float = 0.05, gamma: float = 0.01,
                     loaded: Optional[Set[str]] = None) -> Allocation:
    """Enumerate every allocation (paper semantics). Exponential — small M/B."""
    loaded = loaded or set()
    names = sorted(profiles)
    options = []
    for m in names:
        options.append([0] + _feasible_units(profiles[m], slo_ms, budget))
    best = Allocation(predicted_load=lam)
    for combo in itertools.product(*options):
        if sum(combo) > budget or sum(combo) == 0:
            continue
        units = dict(zip(names, combo))
        a = evaluate(profiles, units, lam, slo_ms, alpha=alpha, beta=beta,
                     gamma=gamma, loaded=loaded)
        if not a.feasible:
            continue
        if a.objective > best.objective or not best.feasible:
            best = a
    if not best.feasible:
        return _best_effort(profiles, lam, budget, slo_ms, alpha=alpha,
                            beta=beta, gamma=gamma, loaded=loaded)
    return best


def solve_exact(profiles: Mapping[str, VariantProfile], lam: float,
                budget: int, slo_ms: float, *, alpha: float = 1.0,
                beta: float = 0.05, gamma: float = 0.01,
                loaded: Optional[Set[str]] = None) -> Allocation:
    """Exact DP. State: (variant idx, budget used, unserved load) — variants
    sorted by accuracy descending so the water-fill quota assignment is the
    DP's min() transition. LC's max-term is handled by solving once per
    candidate LC value and keeping the best total objective."""
    loaded = loaded or set()
    names = sorted(profiles, key=lambda m: -profiles[m].accuracy)
    # load-grid resolution: finer grid shrinks the floor()-discretization
    # error (bounded by max_acc·units_dropped/(λ·res)); capped for memory
    res = int(max(1, min(8, 4096 // max(int(lam), 1))))
    lam_i = int(np.ceil(lam * res))
    # candidate LC caps: 0 (only already-loaded variants) + rt values. With
    # many variants, quantile-dedupe to <= 8 caps (the γ·LC term is coarse —
    # bounded objective error of γ·(rt-gap), negligible at paper scale).
    rts = sorted({profiles[m].rt for m in names if m not in loaded})
    if len(rts) > 8:
        idx = np.linspace(0, len(rts) - 1, 8).round().astype(int)
        rts = [rts[i] for i in idx]
        if rts[-1] != max(rts):
            rts.append(max(rts))
    caps = sorted({0.0} | set(rts))
    best = Allocation(predicted_load=lam)
    for cap in caps:
        usable = [m for m in names
                  if m in loaded or profiles[m].rt <= cap + 1e-12]
        a = _dp_solve(profiles, usable, lam, lam_i, budget, slo_ms,
                      alpha, beta, res=res)
        if a is None:
            continue
        obj = a.objective - gamma * cap
        if obj > best.objective or not best.feasible:
            a.lc = loading_cost(profiles, a.active_variants(), loaded)
            a.objective = a.aa * alpha - beta * a.rc - gamma * a.lc
            best = a
    if not best.feasible:
        return _best_effort(profiles, lam, budget, slo_ms, alpha=alpha,
                            beta=beta, gamma=gamma, loaded=loaded)
    return best


def _dp_solve(profiles, names, lam, lam_i, budget, slo_ms, alpha, beta,
              res: int = 1) -> Optional[Allocation]:
    """DP over (budget, unserved-load) maximizing α·AA − β·RC with full
    coverage required. Vectorized over the (budget × load) grid; returns None
    if no feasible allocation."""
    NEG = -1e18
    U = lam_i
    # V[b, u]: best partial objective having spent b units with u load unserved
    V = np.full((budget + 1, U + 1), NEG)
    V[0, U] = 0.0
    lam_f = max(lam, 1e-9)
    # back-pointers: for each variant, (chosen n, previous u) per state
    back_n: List[np.ndarray] = []
    back_u: List[np.ndarray] = []

    us = np.arange(U + 1)
    for i, m in enumerate(names):
        p = profiles[m]
        V_new = V.copy()                     # n_i = 0 keeps state
        bn = np.zeros((budget + 1, U + 1), np.int32)
        bu = np.tile(us, (budget + 1, 1)).astype(np.int32)
        for n in _feasible_units(p, slo_ms, budget):
            th = int(p.throughput(n) * res)
            gain = (alpha * p.accuracy * np.minimum(us, th) / (lam_f * res)
                    - beta * n)
            rows = V[:budget - n + 1] + gain        # (B', U+1) candidates
            TH = min(th, U)
            # u <= TH all collapse to nu=0: take the best of them per row
            left_u = np.argmax(rows[:, :TH + 1], axis=1)
            left = rows[np.arange(rows.shape[0]), left_u]        # (B',)
            # u > TH map to nu = u - TH (unique)
            right = rows[:, TH + 1:]                             # (B', U-TH)
            cand = np.concatenate([left[:, None], right], axis=1)
            prev_u = np.concatenate(
                [left_u[:, None], np.tile(us[TH + 1:], (rows.shape[0], 1))],
                axis=1).astype(np.int32)
            width = cand.shape[1]
            region = V_new[n:, :width]
            improved = cand > region
            np.copyto(region, cand, where=improved)
            np.copyto(bn[n:, :width], n, where=improved)
            np.copyto(bu[n:, :width], prev_u, where=improved)
        back_n.append(bn)
        back_u.append(bu)
        V = V_new

    # Consider final states within one load-grid cell of full coverage: the
    # floor() discretization can reject a config whose true capacity exactly
    # covers λ. Each candidate is re-validated with exact floats by evaluate().
    best_alloc: Optional[Allocation] = None
    for u_final in range(0, res + 1):
        if u_final > U:
            break
        col = V[:, u_final]
        final_b = int(np.argmax(col))
        if col[final_b] <= NEG / 2:
            continue
        units = {m: 0 for m in names}
        b, u = final_b, u_final
        for i in range(len(names) - 1, -1, -1):
            n = int(back_n[i][b, u])
            pu = int(back_u[i][b, u])
            units[names[i]] = n
            b, u = b - n, pu
        alloc = evaluate(profiles, units, lam, slo_ms, alpha=alpha, beta=beta,
                         gamma=0.0)
        if alloc.feasible and (best_alloc is None
                               or alloc.objective > best_alloc.objective):
            best_alloc = alloc
    return best_alloc


def solve_greedy(profiles: Mapping[str, VariantProfile], lam: float,
                 budget: int, slo_ms: float, *, alpha: float = 1.0,
                 beta: float = 0.05, gamma: float = 0.01,
                 loaded: Optional[Set[str]] = None,
                 prefer_capacity: bool = False) -> Allocation:
    """Heuristic for Eq. 1: marginal-gain construction + steepest local
    repair, O(M·B) objective evaluations — the scalable answer to the
    paper's "Scalability with ML" concern (§7); optimality gap vs
    ``solve_exact`` is measured in benchmarks/solver_scalability."""
    loaded = loaded or set()
    units: Dict[str, int] = {m: 0 for m in profiles}

    def score(u: Dict[str, int]) -> Tuple[float, float]:
        a = evaluate(profiles, u, lam, slo_ms, alpha=alpha, beta=beta,
                     gamma=gamma, loaded=loaded)
        cap = sum(profiles[m].throughput(n) for m, n in u.items() if n > 0)
        if prefer_capacity:
            return (min(cap, lam), a.objective)
        # lexicographic: feasibility first, then objective
        return (1.0 if a.feasible else min(cap / max(lam, 1e-9), 1.0) - 1.0,
                a.objective)

    cur = score(units)
    improved = True
    while improved:
        improved = False
        best_mv, best_sc = None, cur
        used = sum(units.values())
        for m, p in profiles.items():
            lo = p.min_feasible_units(slo_ms)
            if lo is None:
                continue
            # grow moves
            n = units[m]
            step = lo if n == 0 else 1
            if used + step <= budget and n + step <= p.max_units:
                trial = dict(units); trial[m] = n + step
                sc = score(trial)
                if sc > best_sc:
                    best_sc, best_mv = sc, trial
            # shrink / drop moves (cost reduction)
            if n > 0:
                trial = dict(units)
                trial[m] = n - 1 if n - 1 >= lo else 0
                sc = score(trial)
                if sc > best_sc:
                    best_sc, best_mv = sc, trial
        if best_mv is not None:
            units, cur, improved = best_mv, best_sc, True
    out = evaluate(profiles, units, lam, slo_ms, alpha=alpha, beta=beta,
                   gamma=gamma, loaded=loaded)
    return out


def solve_single_variant(profiles: Mapping[str, VariantProfile], lam: float,
                         budget: int, slo_ms: float, *, alpha: float = 1.0,
                         beta: float = 0.05, gamma: float = 0.01,
                         loaded: Optional[Set[str]] = None) -> Allocation:
    """MS+ baseline: exactly one variant + its size, same objective (Eq. 1)."""
    loaded = loaded or set()
    best = Allocation(predicted_load=lam)
    for m, p in profiles.items():
        for n in _feasible_units(p, slo_ms, budget):
            a = evaluate(profiles, {m: n}, lam, slo_ms, alpha=alpha,
                         beta=beta, gamma=gamma, loaded=loaded)
            if a.feasible and (a.objective > best.objective or not best.feasible):
                best = a
    if not best.feasible:
        # under-provisioned: pick max-capacity single variant
        for m, p in profiles.items():
            ns = _feasible_units(p, slo_ms, budget)
            if not ns:
                continue
            n = ns[-1]
            a = evaluate(profiles, {m: n}, lam, slo_ms, alpha=alpha,
                         beta=beta, gamma=gamma, loaded=loaded)
            if a.served > best.served or (a.served == best.served
                                          and a.objective > best.objective):
                best = a
    return best


SOLVERS = {
    "exact": solve_exact,
    "bruteforce": solve_bruteforce,
    "greedy": solve_greedy,
    "single": solve_single_variant,
}
