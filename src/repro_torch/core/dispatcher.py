"""Dispatcher: weighted round-robin load balancing over variant backends.

Implements smooth weighted round-robin (the nginx algorithm): deterministic,
starvation-free, and over any window of W requests each backend receives a
share proportional to its weight — the property the paper needs so realized
per-variant load matches the solver's quota λ_m. Property-tested in
tests/test_dispatcher.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class WeightedRoundRobinDispatcher:
    def __init__(self):
        self._weights: Dict[str, float] = {}
        self._current: Dict[str, float] = {}
        self.dispatched: Dict[str, int] = {}

    def set_weights(self, quotas: Dict[str, float]) -> None:
        """quotas: solver's λ_m per backend (only positive entries kept)."""
        self._weights = {m: float(q) for m, q in quotas.items() if q > 1e-12}
        for m in self._weights:
            self._current.setdefault(m, 0.0)
            self.dispatched.setdefault(m, 0)
        for m in list(self._current):
            if m not in self._weights:
                del self._current[m]

    @property
    def backends(self) -> List[str]:
        return sorted(self._weights)

    def next_backend(self) -> Optional[str]:
        """Smooth WRR: add weights to currents, pick the max, subtract total."""
        if not self._weights:
            return None
        total = sum(self._weights.values())
        best, best_v = None, -np.inf
        for m, w in self._weights.items():
            self._current[m] += w
            if self._current[m] > best_v:
                best, best_v = m, self._current[m]
        self._current[best] -= total
        self.dispatched[best] = self.dispatched.get(best, 0) + 1
        return best

    def realized_shares(self) -> Dict[str, float]:
        tot = sum(self.dispatched.values())
        return {m: c / tot for m, c in self.dispatched.items()} if tot else {}

    def reset(self) -> None:
        """Zero the dispatch counters (and the smooth-WRR phase) so
        ``realized_shares`` reflects only the run that follows — the
        experiment harness calls this at the start of every replay, so a
        reused dispatcher never reports shares polluted by a previous
        trace. Weights are kept: convergence-to-quota restarts cleanly
        (property-tested in tests/test_dispatcher.py)."""
        self.dispatched = {m: 0 for m in self._weights}
        self._current = {m: 0.0 for m in self._weights}
