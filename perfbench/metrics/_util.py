"""Helpers the readers share."""
from __future__ import annotations

import importlib.util
from pathlib import Path

from perfbench.frozen.bound import bound_s


def roofline_share(run, kernel: str):
    """Percent of the roofline bound that the traced launches of
    ``roofline/<kernel>.py`` reached: launches x the bound of one, over
    their summed device time; None without a trace or a launch."""
    if run.kernels is None:
        return None
    path = Path(__file__).resolve().parents[1] / "roofline" / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location("perfbench_roofline_"
                                                  + kernel, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hits = [(s, e) for name, s, e in run.kernels if mod.MATCH in name]
    if not hits:
        return None
    t_dev = sum(e - s for s, e in hits) * 1e-6
    flops, nbytes = mod.counts(run.model, run.geometry)
    t_min, _ = bound_s(nbytes, flops)
    return 100.0 * len(hits) * t_min / t_dev


def idle_share(run):
    if run.kernels is None or not run.trace_window_s > 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)


def window_ticks(run):
    return [t for t in run.ticks if run.w0 <= t.t < run.w1]
