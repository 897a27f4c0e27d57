"""Per-SLO-class error budgets and multi-window burn-rate alerting.

InfAdapter's objective is goodput under a latency SLO (PAPER.md); PR 7's
audit measures how well each decision did *after the run*. This module is
the live half: it reads the rolling windows (``obs.windows``) that both
backends feed at completion time and answers, per SLO class, "how fast is
the error budget burning *right now*" — the SRE multi-window multi-burn-
rate pattern:

* **Error budget** — a target bad-request fraction (``budget``, e.g. 0.05:
  up to 5% of requests may miss their deadline or be dropped).
* **Burn rate** — (observed bad fraction over a window) / budget. Burn 1.0
  consumes the budget exactly; burn 4.0 exhausts it 4x too fast.
* **Multi-window rule** — an alert fires only when BOTH a fast window
  (seconds: catches the spike) and a slow window (the fast window's
  context: filters one-bucket blips) burn above ``threshold``. Each rule
  re-arms after ``cooldown_s`` so a sustained breach re-alerts at a
  bounded rate instead of every check.

SLO **classes** partition requests by their per-request deadline. Class
keys use the same ``f"{slo_ms:g}"`` format as ``summarize_requests``'s
``slo_classes`` (``"150"``, ``"600"``); requests without a deadline fall
in class ``"none"`` (bad = dropped). Backends feed two windowed counters
per class — ``slo.class.<key>.good`` / ``slo.class.<key>.bad`` — from
their completion sinks (engine ``_obs_complete``, DES ``_record``), so
the monitor itself is backend-agnostic and the engine/sim emit identical
windowed names and alert semantics (parity-tested).

Alerts flow to ``AlertSink``s: ``CollectingSink`` queues them for
``InfAdapterController.maybe_react`` (re-solve on breach — the first
consumer of the goodput-aware-control roadmap item) and
``flightrec.FlightTrigger`` dumps a flight snapshot.

Clock-domain rule: ``observe``/``check`` take the owning backend's clock
(wall for the engine, virtual for the DES) — the same stamps the windows
are keyed by.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .windows import MetricWindows

__all__ = ["slo_class_key", "Alert", "AlertSink", "CollectingSink",
           "BurnRateRule", "SLOMonitor", "DEFAULT_RULES"]

_CLASS_PREFIX = "slo.class."


def slo_class_key(slo_ms: float) -> str:
    """Class key for a per-request SLO — the ``summarize_requests``
    ``slo_classes`` format (``750.0 -> "750"``); no deadline -> "none"."""
    return f"{slo_ms:g}" if slo_ms > 0 else "none"


def good_metric(cls: str) -> str:
    return f"{_CLASS_PREFIX}{cls}.good"


def bad_metric(cls: str) -> str:
    return f"{_CLASS_PREFIX}{cls}.bad"


@dataclass(frozen=True)
class Alert:
    """One burn-rate breach: class + rule + the rates that tripped it."""
    t: float
    slo_class: str
    rule: str                 # "fast5s/slow30s" style rule label
    burn_fast: float
    burn_slow: float
    budget: float
    kind: str = "burn_rate"

    def to_dict(self) -> Dict:
        return {"t": self.t, "kind": self.kind, "slo_class": self.slo_class,
                "rule": self.rule, "burn_fast": self.burn_fast,
                "burn_slow": self.burn_slow, "budget": self.budget}


class AlertSink:
    """Receiver interface for burn-rate alerts (``emit`` per alert)."""

    def emit(self, alert: Alert) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class CollectingSink(AlertSink):
    """Queue alerts for a consumer that polls (``maybe_react``): ``alerts``
    keeps the full history, ``pop_pending`` drains the unconsumed tail."""

    def __init__(self) -> None:
        self.alerts: List[Alert] = []
        self._pending: List[Alert] = []

    def emit(self, alert: Alert) -> None:
        self.alerts.append(alert)
        self._pending.append(alert)

    def pending(self) -> int:
        return len(self._pending)

    def pop_pending(self) -> List[Alert]:
        out, self._pending = self._pending, []
        return out


@dataclass(frozen=True)
class BurnRateRule:
    """Alert when burn >= ``threshold`` on BOTH windows (fast AND slow)."""
    fast_s: float = 5.0
    slow_s: float = 30.0
    threshold: float = 2.0

    @property
    def label(self) -> str:
        return f"fast{self.fast_s:g}s/slow{self.slow_s:g}s"


DEFAULT_RULES: Tuple[BurnRateRule, ...] = (BurnRateRule(),)


@dataclass
class _ClassState:
    last_alert_t: Dict[str, float] = field(default_factory=dict)  # rule ->


class SLOMonitor:
    """Evaluate burn-rate rules over the per-class good/bad windows.

    ``check(t)`` discovers classes from the window names (anything a
    backend fed as ``slo.class.<key>.good|bad``), computes each rule's
    fast/slow burn rates, and emits an ``Alert`` to every sink when a rule
    trips outside its cooldown. Windows with fewer than ``min_requests``
    completions (fast window) stay silent — no alerting on noise.
    """

    def __init__(self, windows: MetricWindows, budget: float = 0.05,
                 rules: Sequence[BurnRateRule] = DEFAULT_RULES,
                 sinks: Sequence[AlertSink] = (),
                 cooldown_s: float = 10.0, min_requests: int = 5):
        assert 0 < budget <= 1.0, budget
        self.windows = windows
        self.budget = budget
        self.rules = tuple(rules)
        self.sinks = list(sinks)
        self.cooldown_s = cooldown_s
        self.min_requests = min_requests
        self.alerts: List[Alert] = []            # full history, all classes
        self._state: Dict[str, _ClassState] = {}

    # -------------------------------------------------------------- queries
    def classes(self) -> List[str]:
        seen = set()
        for name in self.windows.names():
            if name.startswith(_CLASS_PREFIX):
                seen.add(name[len(_CLASS_PREFIX):].rsplit(".", 1)[0])
        return sorted(seen)

    def counts(self, cls: str, t: float,
               window_s: float) -> Tuple[float, float]:
        """(good, bad) completions for ``cls`` over the trailing window."""
        g = self.windows.get(good_metric(cls))
        b = self.windows.get(bad_metric(cls))
        return (g.total(t, window_s) if g is not None else 0.0,
                b.total(t, window_s) if b is not None else 0.0)

    def burn_rate(self, cls: str, t: float,
                  window_s: float) -> Optional[float]:
        """(bad fraction over window) / budget; None below min_requests."""
        good, bad = self.counts(cls, t, window_s)
        total = good + bad
        if total < self.min_requests:
            return None
        return (bad / total) / self.budget

    # --------------------------------------------------------------- checks
    def check(self, t: float) -> List[Alert]:
        """Evaluate every (class, rule) pair at clock ``t``; emit + return
        the alerts that fired."""
        if not self.windows.on:
            return []
        fired: List[Alert] = []
        for cls in self.classes():
            st = self._state.setdefault(cls, _ClassState())
            for rule in self.rules:
                bf = self.burn_rate(cls, t, rule.fast_s)
                bs = self.burn_rate(cls, t, rule.slow_s)
                if bf is None or bs is None:
                    continue
                if bf < rule.threshold or bs < rule.threshold:
                    continue
                last = st.last_alert_t.get(rule.label)
                if last is not None and t - last < self.cooldown_s:
                    continue
                st.last_alert_t[rule.label] = t
                a = Alert(t=t, slo_class=cls, rule=rule.label, burn_fast=bf,
                          burn_slow=bs, budget=self.budget)
                fired.append(a)
        for a in fired:
            self.alerts.append(a)
            for sink in self.sinks:
                sink.emit(a)
        return fired
