"""Mean share of the engine's slots occupied, over the ticks of the window
that ran a step (the engine's ``TickRecord.active / max_batch``)."""
from perfbench.metrics._util import window_ticks


def read(run):
    ticks = [t for t in window_ticks(run) if t.kind != "idle"]
    if not ticks:
        return None
    B = run.geometry["max_batch"]
    return 100.0 * sum(t.active for t in ticks) / (B * len(ticks))
