"""The frozen summary arithmetic and the end-to-end metrics over a window:
missing requests count, requests on an edge count by their share."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness
from perfbench.frozen.summary import overlap_share, percentile_with_missing


def test_percentile_matches_numpy_on_finite_values():
    v = list(np.random.default_rng(0).exponential(100.0, 257))
    for q in (50, 95, 99):
        assert percentile_with_missing(v, q) == pytest.approx(
            float(np.percentile(v, q)))


def test_p95_counts_failed_requests_as_missing():
    ok = [100.0] * 95
    assert percentile_with_missing(ok + [None] * 5, 95) == math.inf
    assert percentile_with_missing(ok + [200.0] * 4 + [None], 95) \
        == pytest.approx(float(np.percentile(ok + [200.0] * 5, 95)))
    # a missing request raises the percentile, never lowers it
    base = percentile_with_missing(list(range(100)), 90)
    assert percentile_with_missing(list(range(99)) + [None], 90) >= base


def _rec(due, start, end, n, done=True):
    req = SimpleNamespace(service_start=start, completion=end if done else 0,
                          output=np.zeros(n, np.int64))
    return harness.Rec(plan=None, due=due, req=req)


def _data(recs, w0=10.0, w1=20.0):
    return harness.RunData(cell=None, model={}, geometry={}, w0=w0, w1=w1,
                           recs=recs)


def test_output_tokens_count_by_the_share_of_service_inside_the_window():
    recs = [_rec(10, 10.0, 12.0, 40),     # inside: 40
            _rec(9, 8.0, 12.0, 40),       # half inside: 20
            _rec(19, 18.0, 22.0, 30),     # half inside: 15
            _rec(5, 5.0, 9.0, 50),        # before: 0
            _rec(19, 19.0, 30.0, 8, done=False)]   # never finished
    got = harness.E2E["output_tokens_per_s"](_data(recs), 0.0)
    assert got == pytest.approx((40 + 20 + 15) / 10.0)
    assert overlap_share(8.0, 12.0, 10.0, 20.0) == pytest.approx(0.5)
    assert overlap_share(15.0, 15.0, 10.0, 20.0) == 1.0


def test_p95_latency_is_over_every_request_due_in_the_window():
    recs = [_rec(10 + i * 0.2, 10 + i * 0.2, 10 + i * 0.2 + 1.0, 8)
            for i in range(39)]
    recs.append(_rec(15.0, 0.0, 0.0, 0, done=False))   # rejected
    recs.append(_rec(25.0, 25.0, 26.0, 8))              # due after w1
    recs.append(_rec(9.0, 9.0, 99.0, 8))                # due before w0
    p95 = harness.E2E["p95_latency_ms"](_data(recs), 0.0)
    assert p95 == pytest.approx(1000.0)
    recs += [_rec(16.0, 0.0, 0.0, 0, done=False),
             _rec(17.0, 17.0, 0.0, 0, done=False)]     # never drained
    assert harness.E2E["p95_latency_ms"](_data(recs), 0.0) == math.inf
