"""A device trace of a stretch of work, with the empty-trace retry.

Adapted from ``chip_smoke.py`` ``kernel_events`` (commit 90524296): the
profiler now and then records some of a trace's kernels or none, most
often in the first trace of a process and late in a long one. On the H100
the loss seen is at the trace's start: a trace taken a few minutes into a
process holds its kernels but not the spin kernels launched just after the
profiler started. So three short spin kernels open a trace and three more
close it (after the card drained), none of them counted. A trace is kept
when one of the two groups is all there and at least one other kernel was
recorded; the caller takes another until one is whole. The traced window
is read on the device's own timeline, from the last opening spin kernel
(or, where that group was lost, the first kernel recorded) to the first
closing one (or the last kernel's end), so that a lost edge shortens the
window and leaves no idle time that was not there. ``stop`` ends the traced
stretch; ``close`` then stops the profiler and ``parse`` reads the events,
both slow. ``torch`` and its profiler are imported inside the functions.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

SPIN = "spin_kernel"
SPINS = 3


def start():
    """Start a CUDA trace (spin kernels first); returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    for _ in range(SPINS):
        torch.cuda._sleep(1000)
    return prof


def stop(prof) -> None:
    """Wait for the card, then the closing spin kernels: the traced
    stretch ends here."""
    import torch
    torch.cuda.synchronize()
    for _ in range(SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def close(prof) -> None:
    """Stop the profiler (collecting its buffers takes seconds)."""
    prof.__exit__(None, None, None)


def parse(prof, log=None) -> Optional[Tuple[List[Tuple[str, float, float]],
                                            List[Tuple[str, float, float]],
                                            Tuple[float, float]]]:
    """(device kernels, host ranges, (window start, window end)) of a
    stopped trace, the first two lists of (name, start_us, end_us), the
    window in µs on the device's timeline; None when the trace is not
    whole. Host ranges are the ``bench.*`` ranges the loop records; their
    device-side copies (user annotations) are not kernels. ``log`` gets the
    counts."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            if e.device_type != cuda:
                host.append((e.name, float(tr.start), float(tr.end)))
        elif e.device_type == cuda:
            kernels.append((e.name, float(tr.start), float(tr.end)))
    spins = [k for k in kernels if SPIN in k[0]]
    kernels = [k for k in kernels if SPIN not in k[0]]
    if not kernels:
        if log is not None:
            log(f"[perfbench] trace: {len(spins)} spin kernels, no other")
        return None
    first = min(k[1] for k in kernels)
    last = max(k[2] for k in kernels)
    opening = [k for k in spins if k[2] <= first]
    closing = [k for k in spins if k[1] >= last]
    if log is not None:
        log(f"[perfbench] trace: {len(opening)} of {SPINS} opening and "
            f"{len(closing)} of {SPINS} closing spin kernels, "
            f"{len(kernels)} kernels, {len(host)} host ranges")
    if len(opening) < SPINS and len(closing) < SPINS:
        return None
    t0 = max(k[2] for k in opening) if opening else first
    t1 = min(k[1] for k in closing) if closing else last
    return kernels, host, (t0, t1)


def busy_union_us(kernels: List[Tuple[str, float, float]]) -> float:
    """Microseconds in which at least one kernel ran."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(kernels: List[Tuple[str, float, float]],
              host: List[Tuple[str, float, float]], t0: float, t1: float
              ) -> List[Tuple[str, float]]:
    """Device idle time in [t0, t1] (µs) summed by the innermost host range
    (``bench.*``) that covers each gap's midpoint -> [(label, seconds)]."""
    ivs = sorted(((s, e) for _, s, e in kernels), key=lambda x: x[0])
    gaps, cur = [], t0
    for s, e in ivs:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    by: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = [h for h in host if h[1] <= mid <= h[2]]
        label = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                 else "host:outside bench ranges")
        by[label] = by.get(label, 0.0) + (e - s) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])


def top_kernels(kernels: List[Tuple[str, float, float]], n: int = 10
                ) -> List[Tuple[str, float]]:
    """The ``n`` kernels by summed device seconds."""
    by: dict = {}
    for name, s, e in kernels:
        by[name[:160]] = by.get(name[:160], 0.0) + (e - s) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]
