"""The load generator: one general reader of the traffic files.

A mix (``traffic/<mix>.json``) gives the loop (``closed``: a fixed number
of clients, each sending its next request when its last completes;
``open``: Poisson arrivals), the prompt and output length distributions,
and a block size; an open loop's rate is the cell's (``rate_per_s`` in
``cells/<cell>.json``). The cell's engine cuts the lengths at its
``prompt_len`` and ``max_new``. Every block of ``block`` requests holds
the same lengths (and, for an open loop, the same gaps between arrivals),
taken at evenly spaced quantiles of the distributions, in an order drawn
from ``ORDER_SEED``: every seed sends the same work in the same order. The
seed draws the prompt tokens. Requests are drawn block by block as the
loop asks for them, so a closed loop never runs out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Iterator, Optional

import numpy as np

ORDER_SEED = 20231130


@dataclass
class Planned:
    idx: int
    due: Optional[float]      # seconds after the window opens (open loop)
    tokens: np.ndarray        # prompt ids, int64
    max_new: int


def _quantiles(dist: Dict, n: int, cap: int) -> np.ndarray:
    """``n`` lengths at evenly spaced quantiles of a log-normal
    distribution (``median``, ``sigma``), cut to [``lo``, ``cap``]."""
    if dist["dist"] != "log_normal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    v = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    return np.clip(np.rint(v), int(dist["lo"]), cap).astype(np.int64)


def schedule(traffic: Dict, geometry: Dict, vocab: int, seed: int,
             seconds: float = math.inf) -> Iterator[Planned]:
    """The requests of one run, in order: for an open loop those due
    before ``seconds``, for a closed loop without end."""
    order = np.random.default_rng(ORDER_SEED)
    rng = np.random.default_rng(seed)
    block = int(traffic["block"])
    p_set = _quantiles(traffic["prompt_tokens"], block,
                       int(geometry["prompt_len"]))
    o_set = _quantiles(traffic["output_tokens"], block,
                       int(geometry["max_new"]))
    closed = traffic["loop"] == "closed"
    if not closed:
        rate = float(geometry["rate_per_s"])
        g_set = -np.log(1.0 - (np.arange(block) + 0.5) / block) / rate
    idx, t = 0, 0.0
    while True:
        p = order.permutation(p_set)
        o = order.permutation(o_set)
        g = None if closed else order.permutation(g_set)
        for j in range(block):
            due = None
            if not closed:
                t += float(g[j])
                if t >= seconds:
                    return
                due = t
            toks = rng.integers(1, vocab, size=int(p[j]), dtype=np.int64)
            yield Planned(idx, due, toks, int(o[j]))
            idx += 1
