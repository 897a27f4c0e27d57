"""Share of the traced stretch in which no kernel ran on the card (the
union of the kernels' intervals in ``torch.profiler``'s trace)."""
from perfbench.metrics._util import idle_share


def read(run):
    return idle_share(run)
