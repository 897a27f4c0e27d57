"""Share of the prompt positions the window's prefill calls computed that
held a request's own prompt token: the prompt tokens of the requests
admitted in the window over (prefill calls x max_batch x prompt_len), a
prefill call being a tick that admitted (``TickRecord.admitted > 0``)."""
from perfbench.metrics._util import window_ticks


def read(run):
    calls = sum(1 for t in window_ticks(run) if t.admitted > 0)
    if not calls:
        return None
    g = run.geometry
    useful = sum(len(r.plan.tokens) for r in run.recs
                 if r.req is not None
                 and run.w0 <= r.req.service_start < run.w1)
    return 100.0 * useful / (calls * g["max_batch"] * g["prompt_len"])
