"""The load generator: a seed's schedule repeats exactly, every seed sends
the same lengths in the same order, and a closed loop never runs out."""
import itertools
from statistics import NormalDist

import numpy as np
import pytest

from perfbench import load
from perfbench.spec import load_cell

CLOSED = {"loop": "closed", "block": 16,
          "prompt_tokens": {"dist": "log_normal", "median": 1020,
                            "sigma": 1.0, "lo": 16},
          "output_tokens": {"dist": "log_normal", "median": 129,
                            "sigma": 1.0, "lo": 2}}
OPEN = dict(CLOSED, loop="open")
GEO = {"prompt_len": 512, "max_new": 64, "rate_per_s": 12.5}


def _take(traffic, seed, n=None, seconds=20.0, vocab=49155):
    it = load.schedule(traffic, GEO, vocab, seed, seconds)
    return list(itertools.islice(it, n) if n else it)


@pytest.mark.parametrize("traffic", [CLOSED, OPEN], ids=["closed", "open"])
def test_seeded_schedule_repeats_exactly(traffic):
    seed = 2**31 + 12345
    a, b = _take(traffic, seed, 200), _take(traffic, seed, 200)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_new == y.max_new
        assert np.array_equal(x.tokens, y.tokens)
    c = _take(traffic, seed + 1, 200)
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))


@pytest.mark.parametrize("traffic", [CLOSED, OPEN], ids=["closed", "open"])
def test_every_seed_sends_the_same_lengths_in_the_same_order(traffic):
    runs = [_take(traffic, s, 160, vocab=1000) for s in (1, 2**31 + 9)]
    assert len(runs[0]) == len(runs[1]) >= 2 * traffic["block"]
    for x, y in zip(*runs):
        assert (len(x.tokens), x.max_new, x.due) == \
            (len(y.tokens), y.max_new, y.due)
    lens = [len(q.tokens) for q in runs[0]]
    assert min(lens) >= 16 and max(lens) <= GEO["prompt_len"]
    assert all(2 <= q.max_new <= GEO["max_new"] for q in runs[0])
    assert all(1 <= int(q.tokens.min()) and int(q.tokens.max()) < 1000
               for q in runs[0])


def test_lengths_are_the_distributions_quantiles_cut_at_the_engine():
    blk = CLOSED["block"]
    got = sorted(len(q.tokens) for q in _take(CLOSED, 5, blk))
    u = (np.arange(blk) + 0.5) / blk
    want = [min(512, max(16, round(1020 * np.exp(NormalDist().inv_cdf(x)))))
            for x in u]
    assert got == want
    # the cut: about a quarter of the trace's prompts fit under 512
    assert 0.2 < float(np.mean(np.array(got) < 512)) < 0.3


def test_a_closed_loop_never_runs_out():
    n = 20000      # far more than any window completes
    sched = _take(CLOSED, 3, n, vocab=50)
    assert len(sched) == n and sched[-1].idx == n - 1


def test_open_loop_arrivals_fill_the_window_at_the_rate():
    sched = _take(OPEN, 7, seconds=40.0, vocab=1000)
    due = np.array([q.due for q in sched])
    assert np.all(np.diff(due) > 0) and due[-1] < 40.0
    assert abs(len(sched) / 40.0 - GEO["rate_per_s"]) < 1.0
    gaps = np.diff(np.concatenate([[0.0], due]))[:OPEN["block"]]
    assert sorted(gaps) == pytest.approx(sorted(
        -np.log(1 - (np.arange(16) + 0.5) / 16) / GEO["rate_per_s"]))


def test_the_cells_mixes_load():
    for cell in ("granite-moe.saturate", "internvl2-26b.saturate",
                 "granite-moe.steady"):
        c = load_cell(cell)
        sched = list(itertools.islice(load.schedule(
            c.traffic, c.geometry, c.config["model"]["vocab_size"], 3,
            20.0), 300))
        assert len(sched) > 100
        assert max(len(q.tokens) for q in sched) == c.geometry["prompt_len"]
        assert max(q.max_new for q in sched) == c.geometry["max_new"]
