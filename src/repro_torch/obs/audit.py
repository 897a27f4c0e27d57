"""Controller decision audit log — why the solver chose what it chose,
and what actually happened afterwards.

Each adaptation interval, a controller records one ``DecisionRecord``:

* **inputs** — what the decision was conditioned on: the arrival-rate
  estimate (forecast + any backlog inflation), ``capacity_factor``, the
  profile snapshot used (per-variant base/slope latency, throughput), and
  the reason the solve ran (``interval`` timer vs ``reactive`` headroom
  trigger).
* **outputs** — the chosen variant set with units and quotas, the Eq. 1
  objective terms (aa/rc/lc), and *predicted* latency/goodput derived
  from the same profiles the solver optimized against
  (``predict_outputs``).
* **measured** — attached after the run by ``attach_measured``: requests
  are bucketed into decision windows ``[t_i, t_{i+1})`` by arrival time
  and each window's realized p99 latency and goodput land on the decision
  that governed it, together with the prediction error (**regret**):
  ``regret_p99_ms = measured_p99 - predicted_p99`` and
  ``regret_goodput = predicted_goodput - measured_goodput`` (positive =
  the solver was optimistic).

The log is backend-agnostic: ``sim/runner.py`` attaches measurements from
DES ``ServedRequest``s and ``serving/driver.py`` from engine ``Request``s.
Export with ``to_jsonl`` (one decision per line, rendered into
EXPERIMENTS.md §Observability by ``analysis/report.py``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

__all__ = ["DecisionRecord", "DecisionAudit", "predict_outputs",
           "attach_from_requests"]


def attach_from_requests(audit: "DecisionAudit", requests: Sequence[Any],
                         default_slo_ms: float = 0.0,
                         horizon: Optional[float] = None) -> int:
    """Attach measured outcomes to ``audit`` from served-request records.

    Duck-typed over both backends' per-request types (the engine's
    ``Request`` and the DES's ``ServedRequest``): each record needs
    ``arrival``/``completion`` stamps, and a request counts toward goodput
    when it entered service (``service_start > 0``), was not ``dropped``,
    and met its per-request SLO (falling back to ``default_slo_ms`` when
    the request carries none). No-op (returns 0) when ``audit`` is None or
    has no entries — callers attach opportunistically post-drain.
    """
    if audit is None or not audit.entries or not requests:
        return 0
    arr: List[float] = []
    lat: List[float] = []
    ok: List[bool] = []
    for r in requests:
        arr.append(float(r.arrival))
        l_ms = (float(r.completion) - float(r.arrival)) * 1000.0
        lat.append(l_ms)
        slo = float(getattr(r, "slo_ms", 0.0))
        if slo <= 0:
            slo = default_slo_ms
        served = (float(getattr(r, "service_start", 1.0)) > 0.0
                  and not getattr(r, "dropped", False))
        ok.append(served and (slo <= 0 or l_ms <= slo))
    return audit.attach_measured(arr, lat, ok, horizon=horizon)


def predict_outputs(profiles: Mapping[str, Any], alloc: Any, lam: float,
                    slo_ms: float) -> Dict[str, float]:
    """Predicted latency/goodput implied by an ``Allocation``.

    Duck-typed over ``core.objective``: ``alloc`` needs ``units``/
    ``quotas``; each profile needs ``p99_ms(n)`` and ``throughput(n)``.
    Predicted p99 is reported two ways — quota-weighted mean across active
    variants (what a random admitted request sees) and the max (worst
    variant) — and predicted goodput is the quota share routed to variants
    whose profile-predicted p99 meets the SLO, capped by predicted
    capacity vs the load estimate.
    """
    active = [(m, n) for m, n in alloc.units.items() if n > 0]
    if not active:
        return {"p99_ms": float("nan"), "p99_max_ms": float("nan"),
                "goodput": 0.0, "capacity_rps": 0.0}
    quotas = {m: float(alloc.quotas.get(m, 0.0)) for m, _ in active}
    qsum = sum(quotas.values()) or 1.0
    p99s = {m: float(profiles[m].p99_ms(n)) for m, n in active}
    cap = sum(float(profiles[m].throughput(n)) for m, n in active)
    mean_p99 = sum(quotas[m] / qsum * p99s[m] for m, _ in active)
    ok_share = sum(quotas[m] / qsum for m, _ in active
                   if slo_ms <= 0 or p99s[m] <= slo_ms)
    served_frac = min(1.0, cap / lam) if lam > 0 else 1.0
    return {"p99_ms": mean_p99, "p99_max_ms": max(p99s.values()),
            "goodput": ok_share * served_frac, "capacity_rps": cap}


@dataclass
class DecisionRecord:
    """One controller adaptation: inputs, outputs, and (later) outcome."""
    t: float
    controller: str
    reason: str          # "interval" | "reactive" | "burn_rate" | "warm_start"
    inputs: Dict[str, Any] = field(default_factory=dict)
    outputs: Dict[str, Any] = field(default_factory=dict)
    measured: Optional[Dict[str, Any]] = None
    regret: Optional[Dict[str, float]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"t": self.t, "controller": self.controller,
             "reason": self.reason, "inputs": self.inputs,
             "outputs": self.outputs}
        if self.measured is not None:
            d["measured"] = self.measured
        if self.regret is not None:
            d["regret"] = self.regret
        return d


class DecisionAudit:
    """Append-only decision log with post-hoc measurement attachment."""

    def __init__(self) -> None:
        self.entries: List[DecisionRecord] = []

    def record(self, t: float, controller: str, inputs: Dict[str, Any],
               outputs: Dict[str, Any],
               reason: str = "interval") -> DecisionRecord:
        rec = DecisionRecord(t=float(t), controller=controller,
                             reason=reason, inputs=inputs, outputs=outputs)
        self.entries.append(rec)
        return rec

    # ------------------------------------------------------------ outcomes
    def attach_measured(self, arrivals: Sequence[float],
                        latencies_ms: Sequence[float],
                        ok: Sequence[bool],
                        horizon: Optional[float] = None) -> int:
        """Bucket per-request outcomes into decision windows and attach
        measured p99/goodput + regret to each entry. Requests arriving
        before the first decision are credited to it (warm-up). Entries
        recorded out of timestamp order are SORTED by ``t`` before
        bucketing (windows are defined by decision time, not record
        order) — never an error. Entries whose window caught no requests
        get ``measured={"n_requests": 0}`` and do not count toward the
        returned total. Returns the number of entries that received
        measurements."""
        if not self.entries or not len(arrivals):
            return 0
        order = sorted(range(len(self.entries)),
                       key=lambda i: self.entries[i].t)
        bounds = [self.entries[i].t for i in order]
        arr = np.asarray(arrivals, dtype=float)
        lat = np.asarray(latencies_ms, dtype=float)
        okv = np.asarray(ok, dtype=bool)
        # window k covers [bounds[k], bounds[k+1]); k=0 also takes warm-up
        idx = np.searchsorted(bounds, arr, side="right") - 1
        idx = np.clip(idx, 0, len(bounds) - 1)
        n_attached = 0
        for k, ei in enumerate(order):
            entry = self.entries[ei]
            mask = idx == k
            if horizon is not None and k == len(order) - 1:
                mask &= arr <= horizon
            n = int(mask.sum())
            if n == 0:
                entry.measured = {"n_requests": 0}
                continue
            w_lat = lat[mask]
            measured = {
                "n_requests": n,
                "p99_ms": float(np.percentile(w_lat, 99)),
                "p50_ms": float(np.percentile(w_lat, 50)),
                "mean_ms": float(np.mean(w_lat)),
                "goodput": float(np.mean(okv[mask])),
            }
            entry.measured = measured
            pred = entry.outputs.get("predicted", {})
            if pred:
                entry.regret = {
                    "p99_ms": measured["p99_ms"] - pred.get("p99_ms",
                                                            float("nan")),
                    "goodput": pred.get("goodput", float("nan"))
                               - measured["goodput"],
                }
            n_attached += 1
        return n_attached

    # -------------------------------------------------------------- export
    def to_dicts(self) -> List[Dict[str, Any]]:
        return [e.to_dict() for e in self.entries]

    def to_jsonl(self, path: str) -> int:
        with open(path, "w") as f:
            for e in self.entries:
                f.write(json.dumps(e.to_dict(), sort_keys=True,
                                   default=float) + "\n")
        return len(self.entries)

    def summary(self) -> Dict[str, float]:
        """Aggregate regret across measured decisions (NaN when none)."""
        regs = [e.regret for e in self.entries if e.regret]
        out = {"n_decisions": float(len(self.entries)),
               "n_measured": float(len(regs))}
        if regs:
            gp = [r["goodput"] for r in regs if np.isfinite(r["goodput"])]
            p99 = [r["p99_ms"] for r in regs if np.isfinite(r["p99_ms"])]
            out["mean_abs_goodput_regret"] = (float(np.mean(np.abs(gp)))
                                              if gp else float("nan"))
            out["mean_p99_regret_ms"] = (float(np.mean(p99))
                                         if p99 else float("nan"))
        return out
