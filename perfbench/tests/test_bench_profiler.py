"""The device trace's wholeness and window (``frozen/profiler.parse``) on
made-up events: an edge lost at either end shortens the window, both
lost or no kernel is no trace."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.frozen import profiler as fprof

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def _prof(events):
    return SimpleNamespace(events=lambda: events)


OPEN = [_ev("spin_kernel", 0.0 + i, 1.0 + i) for i in range(3)]
WORK = [_ev("gemm", 10.0, 20.0), _ev("add", 30.0, 35.0)]
CLOSE = [_ev("spin_kernel", 50.0 + i, 51.0 + i) for i in range(3)]
HOST = [_ev("bench.step", 9.0, 36.0, CPU), _ev("bench.step", 9.0, 36.0)]


@pytest.mark.parametrize("events, span", [
    (OPEN + WORK + CLOSE, (3.0, 50.0)),
    (WORK + CLOSE, (10.0, 50.0)),          # the opening spins were lost
    (OPEN[2:] + WORK + CLOSE, (3.0, 50.0)),
    (OPEN + WORK, (3.0, 35.0)),            # the closing spins were lost
])
def test_window_runs_between_the_edges_that_were_recorded(events, span):
    kernels, host, got = fprof.parse(_prof(events + HOST))
    assert got == span
    assert [k[0] for k in kernels] == ["gemm", "add"]
    assert host == [("bench.step", 9.0, 36.0)]
    busy = fprof.busy_union_us(kernels)
    assert busy == 15.0 and busy <= got[1] - got[0]


@pytest.mark.parametrize("events", [
    WORK,                                  # both edges lost
    OPEN[1:] + WORK + CLOSE[:2],           # each edge only in part
    OPEN + CLOSE,                          # no kernel but the spins
    [],
])
def test_a_trace_without_a_whole_edge_or_a_kernel_is_not_kept(events):
    logged = []
    assert fprof.parse(_prof(events + HOST), logged.append) is None
    assert logged


def test_idle_gaps_cover_the_window():
    kernels, host, (t0, t1) = fprof.parse(_prof(OPEN + WORK + CLOSE + HOST))
    gaps = fprof.idle_gaps(kernels, host, t0, t1)
    idle_us = (t1 - t0) - fprof.busy_union_us(kernels)
    assert sum(s for _, s in gaps) == pytest.approx(idle_us * 1e-6)
