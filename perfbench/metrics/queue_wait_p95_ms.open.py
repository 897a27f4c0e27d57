"""95th percentile over the window's requests of the wait from a request's
due time to its ``service_start`` (its prefill call); one never admitted
counts as missing (infinite)."""
from perfbench.frozen.summary import percentile_with_missing


def read(run):
    w = [(r.req.service_start - r.due) * 1e3
         if r.req is not None and r.req.service_start > 0 else None
         for r in run.in_window()]
    return percentile_with_missing(w, 95) if w else None
