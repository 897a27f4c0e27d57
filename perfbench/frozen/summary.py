"""Request-level summary arithmetic.

The percentile and mean arithmetic is copied from
``src/repro_torch/serving/api.py`` ``summarize_requests`` (commit
90524296): ``np.percentile`` with linear interpolation. The population is
corrected: that function scores only the requests that completed, with
their arrival stamped at submission. Here every request due in the window
counts, from the time it was due; one that was rejected, failed or never
drained is missing, and missing counts as an infinite latency, so it can
only raise a percentile. A percentile that lands on a missing request is
infinite, and the caller treats that as a run that failed.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def percentile_with_missing(values_ms: Sequence[Optional[float]],
                            q: float) -> float:
    """The ``q``-th percentile of ``values_ms`` where ``None`` is a missing
    request (+inf); inf when the percentile reaches a missing one."""
    if not values_ms:
        return math.nan
    vals = np.asarray([math.inf if v is None else float(v)
                       for v in values_ms], float)
    vals.sort()
    # np.percentile's linear rule, written out so that a neighbour at +inf
    # gives inf rather than nan (inf * 0)
    pos = (len(vals) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    if frac == 0.0:
        return float(vals[lo])
    if not math.isfinite(vals[hi]):
        return math.inf
    return float(vals[lo] + (vals[hi] - vals[lo]) * frac)


def overlap_share(start: float, end: float, w0: float, w1: float) -> float:
    """The share of [start, end] that lies inside [w0, w1] (1 or 0 for an
    instant)."""
    if end <= start:
        return 1.0 if w0 <= start <= w1 else 0.0
    inside = min(end, w1) - max(start, w0)
    return max(inside, 0.0) / (end - start)
