"""Host/device dispatch-floor attribution over sampled tick records.

The engine's execute phase is three different costs wearing one
``exec_ms`` number: the Python/jit **dispatch** (jax returns before the
device finishes — building and enqueueing the computation), the actual
**device** compute (exposed by fencing the call's outputs with
``jax.block_until_ready``), and the **host sync** tail (the
device-to-host ``np.asarray`` copy plus per-slot token bookkeeping).

With ``InProcessServingEngine(profile_dispatch=N)`` every Nth tick fences
its jitted call and lands the split on its ``TickRecord``
(``dispatch_ms`` / ``device_ms`` / ``host_sync_ms``; NaN on unsampled
ticks). Fencing serializes dispatch and compute, so a sampled tick is a
*measurement*, not the steady state — which is exactly the point: the
dispatch + host-sync floor is the budget the async double-buffered tick
loop (ROADMAP) must hide, and this table is the baseline it gets compared
against.

``dispatch_floor_summary`` aggregates the sampled records per tick type
(fused vs decode) for the EXPERIMENTS.md §Dispatch floor table.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List

import numpy as np

from .trace import TickRecord

__all__ = ["dispatch_floor_summary"]


def dispatch_floor_summary(ticks: Iterable[TickRecord]) -> Dict[str, Dict]:
    """Per-tick-type means/medians of the sampled dispatch/device/host-sync
    split. ``dispatch_frac``/``host_sync_frac`` are the shares of the
    sampled exec phase spent off-device — together, the floor an async
    tick loop could overlap away.

    When the records come from an ``async_tick`` engine, each sampled tick
    also carries the one-tick-lag commit columns (``commit_ms`` /
    ``commit_wait_ms`` / ``hidden_host_ms`` — see ``TickRecord``); their
    means land in the summary so the dispatch-floor table can show how
    much host time the pipeline actually hid (``hidden_host_ms_mean``)
    next to the sync baseline's exposed floor."""
    by_kind: Dict[str, List[TickRecord]] = {}
    for r in ticks:
        if math.isfinite(r.dispatch_ms):
            by_kind.setdefault(r.kind, []).append(r)
    out: Dict[str, Dict] = {}
    for kind, recs in sorted(by_kind.items()):
        disp = np.asarray([r.dispatch_ms for r in recs])
        dev = np.asarray([r.device_ms for r in recs])
        host = np.asarray([r.host_sync_ms for r in recs])
        total = np.maximum(disp + dev + host, 1e-9)
        out[kind] = {
            "n_sampled": len(recs),
            "dispatch_ms_mean": float(disp.mean()),
            "dispatch_ms_p50": float(np.percentile(disp, 50)),
            "device_ms_mean": float(dev.mean()),
            "device_ms_p50": float(np.percentile(dev, 50)),
            "host_sync_ms_mean": float(host.mean()),
            "host_sync_ms_p50": float(np.percentile(host, 50)),
            "exec_ms_mean": float(total.mean()),
            "dispatch_frac": float((disp / total).mean()),
            "host_sync_frac": float((host / total).mean()),
        }
        # async overlap columns: only ticks that committed a previous exec
        acom = [r for r in recs if math.isfinite(r.commit_ms)]
        if acom:
            commit = np.asarray([r.commit_ms for r in acom])
            wait = np.asarray([r.commit_wait_ms for r in acom])
            hidden = np.asarray([r.hidden_host_ms for r in acom])
            out[kind].update({
                "n_async_sampled": len(acom),
                "commit_ms_mean": float(commit.mean()),
                "commit_wait_ms_mean": float(wait.mean()),
                "hidden_host_ms_mean": float(hidden.mean()),
            })
    return out
