"""99th percentile over the window's requests of how late the load
generator submitted each one: its submit time minus its due time, on the
benchmark's clock (a long engine step delays the submissions due during
it)."""
from perfbench.frozen.summary import percentile_with_missing


def read(run):
    lag = [(r.submit - r.due) * 1e3 for r in run.in_window()]
    return percentile_with_missing(lag, 99) if lag else None
